"""Schema layer for the BM25 slice: `text` and `keyword` mappings and JSON
document parsing (the subset of opensearch_tpu.index.mapper the port needs).

- text fields    -> analyzed terms feeding blocked postings (+ field length
                    for norms)
- keyword fields -> exact values feeding postings (term / terms queries)

Objects map to dotted sub-fields and `fields` declares multi-fields, as in
the reference. Other field types are not ported yet: mapping one raises a
mapper_parsing_exception instead of indexing it differently. Dynamic
mapping maps a JSON string to `text` with a `.keyword` sub-field, as the
reference does; a dynamic value of any other type raises for the same
reason.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from opensearch_tpu_torch.analysis.registry import AnalysisRegistry
from opensearch_tpu_torch.common.errors import (IllegalArgumentError,
                                                MapperParsingError)

TEXT_TYPES = {"text"}
KEYWORD_TYPES = {"keyword"}
PORTED_TYPES = TEXT_TYPES | KEYWORD_TYPES
DEFAULT_MAPPING_LIMIT = 1000  # index.mapping.total_fields.limit default
_DATE_PREFIX = re.compile(r"^\d{4}-\d{2}-\d{2}")


@dataclass
class MappedFieldType:
    name: str
    type: str
    analyzer: str = "standard"
    search_analyzer: Optional[str] = None
    index: bool = True
    ignore_above: Optional[int] = None
    null_value: Any = None

    @property
    def is_text(self) -> bool:
        return self.type in TEXT_TYPES

    @property
    def is_keyword(self) -> bool:
        return self.type in KEYWORD_TYPES


@dataclass
class ParsedField:
    """One field's contribution of a parsed document."""
    terms: Optional[List[Tuple[str, int]]] = None  # analyzed (term, position)
    length: int = 0                                 # token count for norms
    exact_values: Optional[List[str]] = None        # keyword exact terms


@dataclass
class ParsedDocument:
    doc_id: str
    source: dict
    fields: Dict[str, ParsedField]


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
            raise MapperParsingError(
                f"No handler for type [{ftype}] declared on field "
                f"[{full_name.split('.')[-1]}]: opensearch_tpu_torch maps "
                f"only {sorted(PORTED_TYPES)} fields so far")
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
        analyzer = spec.get("analyzer", "standard")
        if not self.analysis.has(analyzer):
            raise MapperParsingError(
                f"analyzer [{analyzer}] has not been configured in mappings")
        self.field_types[full_name] = MappedFieldType(
            name=full_name, type=ftype, analyzer=analyzer,
            search_analyzer=spec.get("search_analyzer"),
            index=bool(spec.get("index", True)),
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
        self._parse_object("", source, fields)
        return ParsedDocument(doc_id=doc_id, source=source, fields=fields)

    def _parse_object(self, prefix: str, obj: dict,
                      out: Dict[str, ParsedField]):
        for key, value in obj.items():
            full = f"{prefix}{key}"
            if isinstance(value, dict):
                self._parse_object(f"{full}.", value, out)
            elif isinstance(value, list) and value and all(
                    isinstance(v, dict) for v in value):
                for v in value:
                    self._parse_object(f"{full}.", v, out)
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
        if isinstance(sample, str) and not _DATE_PREFIX.match(sample):
            self._put_field(name, {"type": "text", "fields": {
                "keyword": {"type": "keyword", "ignore_above": 256}}})
            return
        raise MapperParsingError(
            f"dynamic field [{name}] needs a field type opensearch_tpu_torch "
            f"does not map yet (value [{sample!r}])")

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
        else:
            vals = pf.exact_values or []
            for v in values:
                s = str(v)
                if ft.ignore_above is not None \
                        and len(s) > int(ft.ignore_above):
                    continue
                vals.append(s)
            pf.exact_values = vals

    def get_field(self, name: str) -> Optional[MappedFieldType]:
        return self.field_types.get(name)
