"""Per-phase walls of `chip_smoke.py` runs, read from their `--out` logs.

Each line of `DIR/log.txt` starts with the seconds since the script began,
`[t s] label: ...`. A phase owns every line from the first whose label
starts with its own marker (`maxsim:`, not `maxsim corpus:`) until a later
phase's first line; phases a run skips (`--cells`) own none. A phase's
wall is the time of its last line less that of the phase before.

    python -m opensearch_tpu_torch.utils.phase_walls A/log.txt B/log.txt

prints one row a phase, one column a log, and the total.
"""

from __future__ import annotations

import re
import sys
from typing import Dict, List, Tuple

# (phase, the start of the label of its first line), in the order main()
# runs them; phase 2 (the kernels against their plain versions) owns every
# line from `timing:` until serving begins
PHASES: Tuple[Tuple[str, str], ...] = (
    ("1 build", "build:"),
    ("set-up (corpora)", "corpus:"),
    ("2 kernels", "timing:"),
    ("3 serving", "serving:"),
    ("4 scale", "scale:"),
    ("5 agg scale", "agg scale:"),
    ("6 knn exact", "knn exact:"),
    ("7 knn ivf", "knn ivf:"),
    ("8 maxsim", "maxsim:"),
    ("9 hybrid", "hybrid:"),
    ("10 sorted", "sorted:"),
    ("11 agg kinds", "agg kinds:"),
    ("12 relevance", "relevance:"),
    ("13 sharded", "sharded:"),
    ("14 nested", "nested cell:"),
    ("15 geo", "geo cell:"),
    ("16 ingest", "ingest:"),
    ("kernels line", "total wall"),
)

_LINE = re.compile(r"^\[([0-9.]+) s\] (.*)$")


def phase_ends(lines: List[str]) -> Dict[str, float]:
    """The time of each phase's last line (phases with no line are left
    out)."""
    ends: Dict[str, float] = {}
    cur = -1
    for line in lines:
        m = _LINE.match(line)
        if m is None:
            continue
        t, label = float(m.group(1)), m.group(2)
        cur = next((j for j in range(cur + 1, len(PHASES))
                    if label.startswith(PHASES[j][1])), cur)
        if cur >= 0:
            ends[PHASES[cur][0]] = t
    return ends


def phase_walls(lines: List[str]) -> Dict[str, float]:
    """Each phase's wall in seconds: its end less the previous end."""
    walls: Dict[str, float] = {}
    prev = 0.0
    for name, t in phase_ends(lines).items():
        walls[name] = round(t - prev, 1)
        prev = t
    return walls


def main(argv: List[str]) -> int:
    if not argv:
        print(__doc__)
        return 2
    cols = []
    for path in argv:
        with open(path) as f:
            cols.append(phase_walls(f.read().splitlines()))
    print("phase".ljust(18) + "".join(f"{p[-28:]:>30}" for p in argv))
    for name, _ in PHASES:
        print(name.ljust(18) + "".join(
            f"{c[name]:>30.1f}" if name in c else f"{'-':>30}"
            for c in cols))
    print("total".ljust(18) + "".join(
        f"{sum(c.values()):>30.1f}" for c in cols))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
