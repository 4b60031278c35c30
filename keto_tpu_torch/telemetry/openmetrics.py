"""Prometheus / OpenMetrics text-exposition parser (counterpart of
``keto_tpu/telemetry/openmetrics.py``).

The same parser serves the tests and ``chip_smoke.py``, which read both
packages' ``/metrics`` with it, and the fleet's federation scraper
(``telemetry/federation.py``), which re-exports member expositions as
instance-labeled series.

``parse_text(text, openmetrics=False)`` returns a :class:`ParseResult`
whose ``errors`` list carries every *format-level* violation (malformed
samples, illegal labels/escapes, duplicate series, ``# EOF`` discipline,
samples without a family declaration) with line numbers — the linter
reports them verbatim. Semantic conventions (counter ``_total`` suffix,
bucket monotonicity, …) are the linter's job, not the parser's.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional

_FAMILY_RE = re.compile(r"^[a-z][a-z0-9_]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
# a sample line: name{labels} value [# {exemplar-labels} value [ts]]
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r" (?P<value>\S+)"
    r"(?P<exemplar> # \{[^}]*\} \S+(?: \S+)?)?$"
)
_LEGAL_ESCAPES = {"\\", '"', "n"}

HIST_SUFFIXES = ("_bucket", "_sum", "_count")


@dataclass
class Sample:
    name: str
    labels: dict
    value: float
    exemplar: Optional[str] = None
    lineno: int = 0


@dataclass
class Family:
    name: str
    help: Optional[str] = None
    type: Optional[str] = None
    samples: list = field(default_factory=list)


@dataclass
class ParseResult:
    families: dict  # name -> Family, declaration order
    errors: list  # format-level violations, linter-ready strings
    saw_eof: bool = False

    def value(
        self, name: str, labels: Optional[dict] = None
    ) -> Optional[float]:
        """Value of the sample named ``name`` whose label set contains
        ``labels`` (exact subset match); None when absent. The federation
        scraper's main lookup."""
        want = labels or {}
        for s in self.samples_named(name):
            if all(s.labels.get(k) == v for k, v in want.items()):
                return s.value
        return None

    def samples_named(self, name: str) -> list:
        """All samples with exactly this sample name (across families)."""
        out = []
        for fam in self.families.values():
            for s in fam.samples:
                if s.name == name:
                    out.append(s)
        return out

    def sum_counter(self, name: str) -> Optional[float]:
        """Sum over every series of a counter family (e.g. the total of
        ``keto_http_requests_total`` across plane/method/route/code);
        None when the family has no samples."""
        samples = self.samples_named(name)
        if not samples:
            return None
        return sum(s.value for s in samples)


def parse_labels(raw: str):
    """'a="x",b="y"' -> dict, or a string error."""
    labels = {}
    rest = raw
    while rest:
        m = re.match(r'([a-zA-Z_][a-zA-Z0-9_]*)="', rest)
        if m is None:
            return f"malformed label segment {rest!r}"
        name = m.group(1)
        i = m.end()
        value_chars = []
        while i < len(rest):
            c = rest[i]
            if c == "\\":
                if i + 1 >= len(rest):
                    return f"dangling escape in label {name}"
                esc = rest[i + 1]
                if esc not in _LEGAL_ESCAPES:
                    return f"illegal escape \\{esc} in label {name}"
                value_chars.append(c + esc)
                i += 2
                continue
            if c == '"':
                break
            value_chars.append(c)
            i += 1
        else:
            return f"unterminated label value for {name}"
        if name in labels:
            return f"duplicate label name {name}"
        labels[name] = "".join(value_chars)
        rest = rest[i + 1:]
        if rest.startswith(","):
            rest = rest[1:]
        elif rest:
            return f"expected ',' between labels, got {rest!r}"
    return labels


def family_of(sample_name: str, families: dict) -> Optional[str]:
    """Longest declared family this sample name could belong to."""
    if sample_name in families:
        return sample_name
    for suffix in HIST_SUFFIXES:
        if (
            sample_name.endswith(suffix)
            and sample_name[: -len(suffix)] in families
        ):
            return sample_name[: -len(suffix)]
    return None


def parse_text(text: str, openmetrics: bool = False) -> ParseResult:
    """Parse one exposition into families + samples + format errors.

    Every structural rule the wire format defines is enforced here:
    family declarations (one # HELP / # TYPE each, before samples),
    sample-line shape, label grammar and escapes, numeric values,
    exemplar placement (OpenMetrics, ``_bucket`` lines only), duplicate
    series, and the ``# EOF`` terminator discipline.
    """
    errors: list[str] = []
    families: dict[str, Family] = {}
    seen_series: set[tuple] = set()
    lines = text.split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    saw_eof = False
    for lineno, line in enumerate(lines, start=1):
        if saw_eof:
            errors.append(f"line {lineno}: content after # EOF")
            break
        if line == "# EOF":
            if not openmetrics:
                errors.append(
                    f"line {lineno}: # EOF in a non-OpenMetrics exposition"
                )
            saw_eof = True
            continue
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            kind = line[2:6]
            rest = line[7:]
            parts = rest.split(" ", 1)
            name = parts[0]
            payload = parts[1] if len(parts) > 1 else ""
            if not _FAMILY_RE.match(name):
                errors.append(
                    f"line {lineno}: family name {name!r} violates "
                    "lowercase snake_case convention"
                )
            fam = families.setdefault(name, Family(name))
            if kind == "HELP":
                if fam.help is not None:
                    errors.append(
                        f"line {lineno}: duplicate # HELP for {name}"
                    )
                fam.help = payload
            else:
                if fam.type is not None:
                    errors.append(
                        f"line {lineno}: duplicate # TYPE for {name}"
                    )
                if payload not in ("counter", "gauge", "histogram", "summary"):
                    errors.append(
                        f"line {lineno}: unknown TYPE {payload!r} for {name}"
                    )
                if fam.samples:
                    errors.append(
                        f"line {lineno}: # TYPE for {name} after its samples"
                    )
                fam.type = payload
            continue
        if line.startswith("#"):
            continue  # free-form comment
        if not line.strip():
            errors.append(f"line {lineno}: blank line in exposition")
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            errors.append(f"line {lineno}: unparseable sample {line!r}")
            continue
        name = m.group("name")
        raw_labels = m.group("labels")
        labels = parse_labels(raw_labels) if raw_labels else {}
        if isinstance(labels, str):
            errors.append(f"line {lineno}: {labels}")
            continue
        for ln in labels:
            if not _LABEL_NAME_RE.match(ln):
                errors.append(f"line {lineno}: illegal label name {ln!r}")
        try:
            value = float(m.group("value"))
        except ValueError:
            errors.append(
                f"line {lineno}: non-numeric value {m.group('value')!r}"
            )
            continue
        exemplar = m.group("exemplar")
        if exemplar:
            if not openmetrics:
                errors.append(
                    f"line {lineno}: exemplar in a non-OpenMetrics exposition"
                )
            elif not name.endswith("_bucket"):
                errors.append(
                    f"line {lineno}: exemplar on non-bucket sample {name}"
                )
        fam_name = family_of(name, families)
        if fam_name is None:
            errors.append(
                f"line {lineno}: sample {name} has no preceding "
                "# HELP/# TYPE family declaration"
            )
            continue
        fam = families[fam_name]
        fam.samples.append(
            Sample(
                name=name,
                labels=labels,
                value=value,
                exemplar=exemplar.strip() if exemplar else None,
                lineno=lineno,
            )
        )
        if fam.help is None:
            errors.append(f"line {lineno}: {fam_name} missing # HELP")
        if fam.type is None:
            errors.append(f"line {lineno}: {fam_name} missing # TYPE")
        series_key = (name, tuple(sorted(labels.items())))
        if series_key in seen_series:
            errors.append(
                f"line {lineno}: duplicate series {name}"
                f"{dict(sorted(labels.items()))}"
            )
        seen_series.add(series_key)
    if openmetrics and not saw_eof:
        errors.append("OpenMetrics exposition missing trailing # EOF")
    return ParseResult(families=families, errors=errors, saw_eof=saw_eof)
