"""Schema layer: field mappings and JSON document parsing (the subset of
opensearch_tpu.index.mapper the port needs).

- text fields    -> analyzed terms feeding blocked postings (+ field length
                    for norms)
- keyword fields -> exact values feeding postings (term / terms queries) and
                    an ordinal doc-value column (terms aggs, ranges)
- numeric/date/boolean -> f64 doc-value columns; range/term queries compile
                    to rank compares on the column. Booleans also index
                    "true"/"false" postings and an ordinal column.
- knn_vector / dense_vector -> one [dims] f32 row per doc in a matrix
                    column, searched by `knn` (exact scan, or an IVF probe
                    over lists built at seal time).
- rank_vectors   -> one [tokens, dims] f32 matrix per doc (late
                    interaction), scored by `maxsim`; `compression: pq`
                    adds seal-trained product-quantization codes.
- rank_feature   -> a numeric column (positive floats scored by the
                    `rank_feature` query).
- geo_point      -> two hidden aligned double columns `<field>.lat` /
                    `<field>.lon` (the field itself keeps the lats of the
                    points it parsed, for `exists`).
- nested         -> each object under the path becomes its own segment
                    row (`ParsedDocument.children`), joined to its root
                    row as Lucene's doc blocks are.

Objects map to dotted sub-fields and `fields` declares multi-fields, as in
the reference. Other field types are not ported yet: mapping one raises a
mapper_parsing_exception instead of indexing it differently. Dynamic
mapping follows the reference: a JSON string maps to `text` with a
`.keyword` sub-field (or `date` when it looks like one), an integer to
`long`, a float to `float` and a boolean to `boolean`.
"""

from __future__ import annotations

import datetime as _dt
import fnmatch
import functools
import math
import re
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Optional, Tuple

from opensearch_tpu_torch.analysis.registry import AnalysisRegistry
from opensearch_tpu_torch.common.errors import (IllegalArgumentError,
                                                MapperParsingError)

TEXT_TYPES = {"text"}
KEYWORD_TYPES = {"keyword"}
NUMERIC_TYPES = {"long", "integer", "short", "byte", "double", "float",
                 # rank features are positive floats with doc values; their
                 # scoring lives in the rank_feature query
                 "rank_feature"}
DATE_TYPES = {"date"}
BOOL_TYPES = {"boolean"}
VECTOR_TYPES = {"knn_vector", "dense_vector"}
# late-interaction multi-vector fields (ColBERT-style): one [tokens, dims]
# matrix per doc, scored by the MaxSim kernels (ops/maxsim.py)
RANK_VECTOR_TYPES = {"rank_vectors"}
RANK_VECTORS_COMPRESSION = ("none", "pq")
DEFAULT_MAX_TOKENS = 128
GEO_POINT = "geo_point"
PORTED_TYPES = (TEXT_TYPES | KEYWORD_TYPES | NUMERIC_TYPES | DATE_TYPES
                | BOOL_TYPES | VECTOR_TYPES | RANK_VECTOR_TYPES
                | {GEO_POINT})
# every type the reference maps (opensearch_tpu/index/mapper.py's known
# set): a type in it that the port does not map yet answers the reference's
# reason with the port's suffix, any other type the reference's reason alone
REFERENCE_TYPES = PORTED_TYPES | {
    "match_only_text", "search_as_you_type", "constant_keyword", "wildcard",
    "completion", "half_float", "scaled_float", "unsigned_long",
    "date_nanos", "ip", "geo_shape", "integer_range", "long_range",
    "float_range", "double_range", "date_range", "ip_range", "object",
    "binary", "percolator"}
DEFAULT_MAPPING_LIMIT = 1000  # index.mapping.total_fields.limit default

_INT_BOUNDS = {
    "byte": (-2 ** 7, 2 ** 7 - 1),
    "short": (-2 ** 15, 2 ** 15 - 1),
    "integer": (-2 ** 31, 2 ** 31 - 1),
    "long": (-2 ** 63, 2 ** 63 - 1),
}


def parse_date_millis(value: Any, fmt: Optional[str] = None) -> int:
    """Parse a date into epoch milliseconds: the reference's default
    `strict_date_optional_time||epoch_millis`, plus `epoch_second`."""
    if isinstance(value, bool):
        raise MapperParsingError(f"failed to parse date field [{value}]")
    if isinstance(value, (int, float)):
        n = int(value)
        return n * 1000 if fmt == "epoch_second" else n
    text = str(value).strip()
    if fmt in ("epoch_millis", "epoch_second") \
            or re.fullmatch(r"-?\d{10,}", text):
        try:
            n = int(text)
            return n * 1000 if fmt == "epoch_second" else n
        except ValueError:
            pass
    # ISO-8601 family: yyyy, yyyy-MM, yyyy-MM-dd, optional time and zone
    t = text.replace("Z", "+00:00")
    for pattern in (None, "%Y-%m", "%Y"):
        try:
            if pattern is None:
                dt = _dt.datetime.fromisoformat(t)
            else:
                dt = _dt.datetime.strptime(t, pattern)
            if dt.tzinfo is None:
                dt = dt.replace(tzinfo=_dt.timezone.utc)
            return int(dt.timestamp() * 1000)
        except ValueError:
            continue
    raise MapperParsingError(
        f"failed to parse date field [{value}] with format "
        f"[{fmt or 'strict_date_optional_time||epoch_millis'}]")


@functools.lru_cache(maxsize=1 << 16)
def format_date_millis(millis: int) -> str:
    """Epoch millis -> `yyyy-MM-ddTHH:mm:ss.SSSZ` (memoized: histogram
    renders format the same bucket keys for every query)."""
    dt = _dt.datetime.fromtimestamp(millis / 1000.0, tz=_dt.timezone.utc)
    return dt.strftime("%Y-%m-%dT%H:%M:%S.") \
        + f"{dt.microsecond // 1000:03d}Z"


def _parse_boolish(value: Any) -> bool:
    if isinstance(value, bool):
        return value
    text = str(value).strip().lower()
    if text == "true":
        return True
    if text in ("false", ""):
        return False
    raise MapperParsingError(f"Failed to parse value [{value}] as only "
                             f"[true] or [false] are allowed.")


@dataclass
class MappedFieldType:
    name: str
    type: str
    analyzer: str = "standard"
    search_analyzer: Optional[str] = None
    index: bool = True
    doc_values: bool = True
    fmt: Optional[str] = None            # date format
    dims: int = 0                        # vectors
    similarity_space: str = "l2"         # l2 | cosinesimil | innerproduct
    knn_method: str = "exact"            # exact | ivf (hnsw maps to ivf)
    knn_nlist: int = 128                 # ivf: number of centroids
    knn_nprobe: int = 0                  # ivf: default probes (0 -> nlist/8)
    max_tokens: int = 0                  # rank_vectors: per-doc token cap
    compression: str = "none"            # rank_vectors: none | pq
    pq_m: int = 0                        # rank_vectors pq: subspace count
    ignore_above: Optional[int] = None
    null_value: Any = None

    @property
    def is_text(self) -> bool:
        return self.type in TEXT_TYPES

    @property
    def is_keyword(self) -> bool:
        return self.type in KEYWORD_TYPES

    @property
    def is_numeric(self) -> bool:
        return self.type in NUMERIC_TYPES

    @property
    def is_date(self) -> bool:
        return self.type in DATE_TYPES

    @property
    def is_bool(self) -> bool:
        return self.type in BOOL_TYPES

    @property
    def is_vector(self) -> bool:
        return self.type in VECTOR_TYPES

    @property
    def is_rank_vectors(self) -> bool:
        return self.type in RANK_VECTOR_TYPES

    @property
    def has_ordinals(self) -> bool:
        """Fields whose doc values are ordinal-encoded strings."""
        return self.is_keyword or self.is_bool

    def parse_numeric(self, value: Any) -> float:
        """Doc-value columns are float64, so integer fields keep exact
        values up to 2**53, as in the reference; the bounds checks are
        exact regardless."""
        if isinstance(value, bool):
            raise MapperParsingError(
                f"failed to parse field [{self.name}] of type "
                f"[{self.type}]: boolean value not allowed")
        if self.type in _INT_BOUNDS:
            if isinstance(value, int):
                n = value
            elif isinstance(value, str) \
                    and re.fullmatch(r"-?\d+", value.strip()):
                n = int(value.strip())
            else:
                try:
                    num = float(value)
                except (TypeError, ValueError) as e:
                    raise MapperParsingError(
                        f"failed to parse field [{self.name}] of type "
                        f"[{self.type}] value [{value}]") from e
                if math.isnan(num) or math.isinf(num):
                    raise MapperParsingError(
                        f"[{self.type}] supports only finite values, but "
                        f"got [{value}]")
                n = int(num)  # coerce: truncate decimals
            lo, hi = _INT_BOUNDS[self.type]
            if not lo <= n <= hi:
                raise MapperParsingError(
                    f"Value [{value}] is out of range for a {self.type}")
            return float(n)
        try:
            num = float(value)
        except (TypeError, ValueError) as e:
            raise MapperParsingError(
                f"failed to parse field [{self.name}] of type [{self.type}] "
                f"value [{value}]") from e
        if math.isnan(num) or math.isinf(num):
            raise MapperParsingError(f"[{self.type}] supports only finite "
                                     f"values, but got [{value}]")
        return num

    def to_comparable(self, value: Any) -> float:
        """A query value in the doc-value column's domain."""
        if self.is_date:
            return float(parse_date_millis(value, self.fmt))
        if self.is_bool:
            return 1.0 if _parse_boolish(value) else 0.0
        return self.parse_numeric(value)


@dataclass
class ParsedField:
    """One field's contribution of a parsed document."""
    terms: Optional[List[Tuple[str, int]]] = None  # analyzed (term, position)
    length: int = 0                                 # token count for norms
    exact_values: Optional[List[str]] = None        # keyword exact terms
    numeric_values: Optional[List[float]] = None    # numeric/date/bool values
    vector: Optional[List[float]] = None            # knn_vector row
    token_vectors: Optional[List[List[float]]] = None  # rank_vectors matrix


@dataclass
class ParsedDocument:
    """`children` holds one (nested path, fields) entry per nested object:
    each becomes its own row of the segment's doc block, the children
    before their root row (Lucene's block-join order)."""
    doc_id: str
    source: dict
    fields: Dict[str, ParsedField]
    children: List[Tuple[str, Dict[str, ParsedField]]] = \
        dc_field(default_factory=list)


class MapperService:
    """Holds one index's mapping; parses documents and merges mapping
    updates. The mapping dict uses the REST shape:
    {"properties": {"f": {"type": "text", "fields": {...}}}}."""

    def __init__(self, mapping: Optional[dict] = None,
                 analysis_registry: Optional[AnalysisRegistry] = None,
                 dynamic: Any = True,
                 total_fields_limit: int = DEFAULT_MAPPING_LIMIT):
        self.analysis = analysis_registry or AnalysisRegistry()
        self.field_types: Dict[str, MappedFieldType] = {}
        self._multi_children: Dict[str, List[str]] = {}
        # nested object paths: each value under such a path becomes its
        # own segment row
        self.nested_paths: set = set()
        self.dynamic = dynamic
        self.total_fields_limit = total_fields_limit
        if mapping:
            self.merge(mapping)

    # ------------------------------------------------------------- mapping
    def merge(self, mapping: dict):
        mapping = mapping.get("mappings", mapping)
        if "dynamic" in mapping:
            self.dynamic = mapping["dynamic"]
        self._merge_properties("", mapping.get("properties", {}))

    def _merge_properties(self, prefix: str, properties: dict):
        for name, spec in properties.items():
            if not isinstance(spec, dict):
                raise MapperParsingError(
                    f"Expected map for property [{prefix}{name}]")
            full = f"{prefix}{name}"
            sub_properties = spec.get("properties")
            if spec.get("type") == "nested":
                self.nested_paths.add(full)
                self._merge_properties(f"{full}.", sub_properties or {})
                continue
            if sub_properties is not None or spec.get("type") == "object":
                self._merge_properties(f"{full}.", sub_properties or {})
                continue
            if spec.get("type") is None:
                raise MapperParsingError(
                    f"No type specified for field [{full}]")
            self._put_field(full, spec)

    def _put_field(self, full_name: str, spec: dict):
        ftype = spec.get("type")
        if ftype not in PORTED_TYPES:
            reason = (f"No handler for type [{ftype}] declared on field "
                      f"[{full_name.split('.')[-1]}]")
            if ftype in REFERENCE_TYPES:
                reason += (f": opensearch_tpu_torch maps only "
                           f"{sorted(PORTED_TYPES)} fields so far")
            raise MapperParsingError(reason)
        existing = self.field_types.get(full_name)
        if existing is not None and existing.type != ftype:
            raise IllegalArgumentError(
                f"mapper [{full_name}] cannot be changed from type "
                f"[{existing.type}] to [{ftype}]")
        if len(self.field_types) >= self.total_fields_limit \
                and existing is None:
            raise IllegalArgumentError(
                f"Limit of total fields [{self.total_fields_limit}] has been "
                f"exceeded")
        dims = 0
        if ftype in VECTOR_TYPES or ftype in RANK_VECTOR_TYPES:
            dims = int(spec.get("dimension", spec.get("dims", 0)))
            if dims <= 0:
                raise MapperParsingError(
                    f"dimension must be set for vector field [{full_name}]")
        max_tokens = 0
        compression = "none"
        pq_m = 0
        if ftype in RANK_VECTOR_TYPES:
            max_tokens = int(spec.get("max_tokens", DEFAULT_MAX_TOKENS))
            if max_tokens <= 0:
                raise MapperParsingError(
                    f"max_tokens must be a positive integer for "
                    f"rank_vectors field [{full_name}]")
            compression = str(spec.get("compression", "none"))
            if compression not in RANK_VECTORS_COMPRESSION:
                raise MapperParsingError(
                    f"compression must be one of "
                    f"{list(RANK_VECTORS_COMPRESSION)} for rank_vectors "
                    f"field [{full_name}], got [{compression}]")
            if compression == "pq":
                # subspace count: explicit `pq_m`, or 4-dim subvectors
                # (scalar subspaces for dims not a multiple of 4)
                pq_m = int(spec.get("pq_m",
                                    dims // 4 if dims % 4 == 0 else dims))
                if pq_m <= 0 or dims % pq_m != 0:
                    raise MapperParsingError(
                        f"pq_m [{pq_m}] must evenly divide dimension "
                        f"[{dims}] for rank_vectors field [{full_name}]")
        analyzer = spec.get("analyzer", "standard")
        if not self.analysis.has(analyzer):
            raise MapperParsingError(
                f"analyzer [{analyzer}] has not been configured in mappings")
        method_spec = spec.get("method", {}) or {}
        space = method_spec.get("space_type", spec.get("space_type", "l2"))
        # HNSW's graph walk has no dense equivalent: it maps to IVF
        method_name = method_spec.get("name", "exact")
        if method_name in ("hnsw", "ivf"):
            method_name = "ivf"
        method_params = method_spec.get("parameters", {}) or {}
        if ftype == GEO_POINT:
            # two aligned hidden columns: a sorted value-pair column would
            # lose which value belongs to which axis
            for axis in ("lat", "lon"):
                self.field_types[f"{full_name}.{axis}"] = MappedFieldType(
                    name=f"{full_name}.{axis}", type="double")
        self.field_types[full_name] = MappedFieldType(
            name=full_name, type=ftype, analyzer=analyzer,
            search_analyzer=spec.get("search_analyzer"),
            index=bool(spec.get("index", True)),
            doc_values=bool(spec.get("doc_values", True)),
            fmt=spec.get("format"),
            dims=dims,
            similarity_space=space,
            knn_method=method_name,
            knn_nlist=int(method_params.get("nlist", 128)),
            knn_nprobe=int(method_params.get("nprobes",
                                             method_params.get("nprobe", 0))),
            max_tokens=max_tokens,
            compression=compression,
            pq_m=pq_m,
            ignore_above=spec.get("ignore_above"),
            null_value=spec.get("null_value"))
        for sub_name, sub_spec in spec.get("fields", {}).items():
            sub_full = f"{full_name}.{sub_name}"
            self._put_field(sub_full, sub_spec)
            children = self._multi_children.setdefault(full_name, [])
            if sub_full not in children:
                children.append(sub_full)

    # ------------------------------------------------------------ parsing
    def parse_document(self, doc_id: str, source: dict) -> ParsedDocument:
        if not isinstance(source, dict):
            raise MapperParsingError(
                "failed to parse: document must be an object")
        fields: Dict[str, ParsedField] = {}
        children: List[Tuple[str, Dict[str, ParsedField]]] = []
        self._parse_object("", source, fields, children)
        return ParsedDocument(doc_id=doc_id, source=source, fields=fields,
                              children=children)

    def _parse_object(self, prefix: str, obj: dict,
                      out: Dict[str, ParsedField],
                      children: Optional[List] = None):
        for key, value in obj.items():
            full = f"{prefix}{key}"
            if full in self.nested_paths and children is not None:
                # each nested object becomes its own row; its sub-fields
                # stay off the parent row. A nested path inside a nested
                # object appends its own rows to the same block (each
                # joins the root)
                elems = value if isinstance(value, list) else [value]
                for elem in elems:
                    if elem is None:
                        continue
                    if not isinstance(elem, dict):
                        raise MapperParsingError(
                            f"object mapping for [{full}] tried to parse "
                            f"field as object, but found a concrete value")
                    child_fields: Dict[str, ParsedField] = {}
                    self._parse_object(f"{full}.", elem, child_fields,
                                       children)
                    children.append((full, child_fields))
                continue
            if isinstance(value, dict):
                # a {"lat", "lon"} geo_point lands in its hidden columns
                # as two dotted doubles, as in the reference
                self._parse_object(f"{full}.", value, out, children)
            elif isinstance(value, list) and value and all(
                    isinstance(v, dict) for v in value):
                for v in value:
                    self._parse_object(f"{full}.", v, out, children)
            else:
                self._parse_value(full, value, out)

    def _dynamic_map(self, name: str, value: Any):
        if self.dynamic in (False, "false", "strict"):
            if self.dynamic == "strict":
                raise MapperParsingError(
                    f"mapping set to strict, dynamic introduction of "
                    f"[{name}] within [_doc] is not allowed")
            return
        sample = value[0] if isinstance(value, list) and value else value
        if isinstance(sample, bool):
            self._put_field(name, {"type": "boolean"})
        elif isinstance(sample, int):
            self._put_field(name, {"type": "long"})
        elif isinstance(sample, float):
            self._put_field(name, {"type": "float"})
        elif isinstance(sample, str):
            try:
                parse_date_millis(sample)
                looks_like_date = bool(
                    re.match(r"^\d{4}-\d{2}-\d{2}", sample))
            except MapperParsingError:
                looks_like_date = False
            if looks_like_date:
                self._put_field(name, {"type": "date"})
            else:
                self._put_field(name, {"type": "text", "fields": {
                    "keyword": {"type": "keyword", "ignore_above": 256}}})

    def _parse_value(self, name: str, value: Any,
                     out: Dict[str, ParsedField],
                     into_multi_fields: bool = True):
        if name not in self.field_types:
            if value is None:
                return
            self._dynamic_map(name, value)
            if name not in self.field_types:
                return
        if into_multi_fields:
            for sub in self._multi_children.get(name, ()):
                self._parse_value(sub, value, out, into_multi_fields=False)
        ft = self.field_types[name]
        values = value if isinstance(value, list) else [value]
        values = [v for v in values if v is not None]
        if ft.null_value is not None and not values:
            values = [ft.null_value]
        if not values:
            return
        pf = out.setdefault(name, ParsedField())
        if ft.is_text:
            analyzer = self.analysis.get(ft.analyzer)
            terms: List[Tuple[str, int]] = pf.terms or []
            # positions continue past the last one with the 100-position
            # gap between values (Lucene position_increment_gap)
            base = (terms[-1][1] + 1 + 100) if terms else 0
            for v in values:
                toks = analyzer.analyze(str(v))
                terms.extend((t, base + p) for t, p in toks)
                if toks:
                    base += toks[-1][1] + 1 + 100
            pf.terms = terms
            pf.length = len(terms)
        elif ft.is_keyword:
            vals = pf.exact_values or []
            for v in values:
                s = str(v)
                if ft.ignore_above is not None \
                        and len(s) > int(ft.ignore_above):
                    continue
                vals.append(s)
            pf.exact_values = vals
        elif ft.is_numeric:
            nums = pf.numeric_values or []
            nums.extend(ft.parse_numeric(v) for v in values)
            pf.numeric_values = nums
        elif ft.is_date:
            nums = pf.numeric_values or []
            nums.extend(float(parse_date_millis(v, ft.fmt)) for v in values)
            pf.numeric_values = nums
        elif ft.is_bool:
            bools = [_parse_boolish(v) for v in values]
            pf.numeric_values = (pf.numeric_values or []) + [
                1.0 if b else 0.0 for b in bools]
            pf.exact_values = (pf.exact_values or []) + [
                "true" if b else "false" for b in bools]
        elif ft.is_rank_vectors:
            # one [tokens, dims] matrix per doc: an array of per-token
            # vectors
            if not isinstance(value, list) or not all(
                    isinstance(t, list) for t in values):
                raise MapperParsingError(
                    f"failed to parse rank_vectors field [{name}]: "
                    f"expected an array of token vectors")
            if len(values) > ft.max_tokens:
                raise MapperParsingError(
                    f"rank_vectors field [{name}] has {len(values)} token "
                    f"vectors, more than max_tokens [{ft.max_tokens}]")
            toks: List[List[float]] = []
            for t in values:
                if len(t) != ft.dims or not all(
                        isinstance(v, (int, float))
                        and not isinstance(v, bool) for v in t):
                    raise MapperParsingError(
                        f"Vector dimension mismatch for field [{name}]: "
                        f"expected {ft.dims}, got {len(t)}")
                toks.append([float(v) for v in t])
            pf.token_vectors = toks
        elif ft.is_vector:
            if isinstance(value, list) and all(isinstance(v, (int, float))
                                               for v in value):
                vec = [float(v) for v in value]
            else:
                raise MapperParsingError(
                    f"failed to parse vector field [{name}]: expected array "
                    f"of numbers")
            if len(vec) != ft.dims:
                raise MapperParsingError(
                    f"Vector dimension mismatch for field [{name}]: "
                    f"expected {ft.dims}, got {len(vec)}")
            pf.vector = vec
        elif ft.type == GEO_POINT:
            # "lat,lon" strings and [lon, lat] arrays (one point or a list
            # of them); the field keeps the lats, its hidden columns both
            # axes
            if isinstance(value, (list, tuple)) and len(value) == 2 \
                    and all(isinstance(v, (int, float)) for v in value):
                points = [list(value)]
            elif isinstance(value, list):
                points = value
            else:
                points = [value]
            nums = pf.numeric_values or []
            lat_pf = out.setdefault(f"{name}.lat", ParsedField())
            lon_pf = out.setdefault(f"{name}.lon", ParsedField())
            lat_pf.numeric_values = lat_pf.numeric_values or []
            lon_pf.numeric_values = lon_pf.numeric_values or []
            for v in points:
                lat, lon = parse_geo_point(v)
                nums.append(lat)
                lat_pf.numeric_values.append(lat)
                lon_pf.numeric_values.append(lon)
            pf.numeric_values = nums

    def get_field(self, name: str) -> Optional[MappedFieldType]:
        return self.field_types.get(name)

    def expand_field_patterns(self, fields) -> List[str]:
        """Wildcard field specs ("text*", "*_name^2") expanded against the
        mapping, in mapping order; a boost suffix carries to every
        expansion. multi_match and query_string resolve their fields
        here."""
        out: List[str] = []
        for fspec in fields:
            fname, caret, fboost = str(fspec).partition("^")
            if "*" not in fname:
                out.append(fspec)
                continue
            for actual in self.field_types:
                if fnmatch.fnmatchcase(actual, fname):
                    out.append(f"{actual}^{fboost}" if caret else actual)
        return out


def parse_geo_point(value: Any) -> Tuple[float, float]:
    """(lat, lon) of a geo point in its wire shapes: {"lat", "lon"}, a
    GeoJSON [lon, lat] pair and a "lat,lon" string."""
    if isinstance(value, dict):
        return float(value["lat"]), float(value["lon"])
    if isinstance(value, (list, tuple)) and len(value) == 2:
        return float(value[1]), float(value[0])
    if isinstance(value, str) and "," in value:
        lat, lon = value.split(",", 1)
        return float(lat), float(lon)
    raise MapperParsingError(f"failed to parse geo_point [{value}]")
