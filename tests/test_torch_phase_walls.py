"""utils/phase_walls.py: a chip_smoke log's lines fall into their phases,
and each phase's wall is its last line's time less the previous phase's."""

import pytest

from opensearch_tpu_torch.utils.phase_walls import (PHASES, main,
                                                    phase_ends, phase_walls)

LOG = """\
[19.0 s] build: {"bm25_candidate": 12.4} s
[19.1 s] card: NVIDIA H100 80GB HBM3, 700.00 W
[37.9 s] corpus: 1000000 passages
[82.3 s] maxsim corpus: [16, 2048, 128]
[82.3 s] timing: a median of up to 15 reps
[146.9 s] nested and geo cells: built
[307.0 s] expand_pad: 64 leaves
[338.8 s] serving: seventeen indices loaded
[386.8 s] serving: 50 BM25 pages
[386.9 s] scale: image of 1000000 docs
[387.8 s] profile msearch32: 6 B=32 waves
[388.0 s] scale: {"image_bytes": 1}
  a line without a time
[479.4 s] maxsim: B=1 wall
[488.9 s] maxsim: {"p50": 1}
[914.8 s] total wall 908.551 s
"""


def test_lines_fall_into_their_phases():
    ends = phase_ends(LOG.splitlines())
    assert ends == {"1 build": 19.1, "set-up (corpora)": 82.3,
                    "2 kernels": 307.0, "3 serving": 386.8,
                    "4 scale": 388.0, "8 maxsim": 488.9,
                    "kernels line": 914.8}


def test_walls_are_differences_of_ends():
    walls = phase_walls(LOG.splitlines())
    assert walls["1 build"] == 19.1
    assert walls["2 kernels"] == pytest.approx(307.0 - 82.3, abs=0.05)
    assert walls["8 maxsim"] == pytest.approx(488.9 - 388.0, abs=0.05)
    assert sum(walls.values()) == pytest.approx(914.8, abs=0.2)


def test_a_later_label_does_not_end_a_phase_early():
    """`maxsim corpus:` in the set-up does not start phase 8, and the
    nested and geo set-up line in phase 2 does not start phase 14."""
    ends = phase_ends(LOG.splitlines())
    assert "14 nested" not in ends and "15 geo" not in ends
    assert ends["8 maxsim"] > ends["4 scale"]


def test_main_prints_a_row_a_phase(tmp_path, capsys):
    log = tmp_path / "log.txt"
    log.write_text(LOG)
    assert main([str(log), str(log)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1 + len(PHASES) + 1
    assert out[-1].split()[1:] == ["914.8", "914.8"]
    assert main([]) == 2
