"""Prometheus text-exposition-format validator (port of the JAX package's
``obs/exposition.py``).

An in-tree checker for the ``/metrics`` outputs the servers compose from
hand-rolled ``*_metrics_lines`` helpers plus the histogram families, where
format drift is a real risk.  The port's tests and ``chip_smoke.py`` parse
``/metrics`` with it; import-safe for ops tooling.

Checks (subset of the exposition spec that matters for scrapers):
  * sample lines parse: ``name{labels} value``;
  * no duplicate series (same name + same label set twice);
  * at most one ``# TYPE`` per family, and it precedes that family's
    first sample;
  * label values carry no raw quote/newline/backslash (must be escaped);
  * histograms: ``le`` buckets are sorted and cumulative-monotonic, end
    with a ``+Inf`` terminal equal to ``_count``, and ``_sum``/``_count``
    are present.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r"\s+(?P<value>[^\s]+)\s*$"
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


class ExpositionError(ValueError):
    """Raised on the first violation, with the offending line."""


@dataclass
class Sample:
    name: str
    labels: tuple
    value: float
    line_no: int


@dataclass
class Exposition:
    samples: list = field(default_factory=list)
    types: dict = field(default_factory=dict)  # family -> declared type

    def value(self, name: str, **labels: str) -> float:
        want = tuple(sorted(labels.items()))
        for s in self.samples:
            if s.name == name and s.labels == want:
                return s.value
        raise KeyError(f"{name}{labels!r} not found")


def _family_of(name: str) -> str:
    """The family a sample belongs to for TYPE bookkeeping: histogram and
    summary samples use the base name's declaration."""
    for suffix in ("_bucket", "_sum", "_count", "_max"):
        if name.endswith(suffix):
            return name[: -len(suffix)]
    return name


def _parse_labels(raw: str, line_no: int) -> tuple:
    if not raw:
        return ()
    out = []
    pos = 0
    while pos < len(raw):
        m = _LABEL_RE.match(raw, pos)
        if m is None:
            raise ExpositionError(f"line {line_no}: malformed labels: {{{raw}}}")
        value = m.group(2)
        # The regex already guarantees quotes/backslashes are escaped;
        # reject raw newlines (they would have split the line anyway) and
        # stray escape sequences.
        if re.search(r"\\[^\\n\"]", value):
            raise ExpositionError(
                f"line {line_no}: invalid escape in label value: {value!r}"
            )
        out.append((m.group(1), value))
        pos = m.end()
        if pos < len(raw) and raw[pos] == ",":
            pos += 1
    return tuple(sorted(out))


def _le_key(le: str) -> float:
    return float("inf") if le == "+Inf" else float(le)


def parse_exposition(text: str) -> Exposition:
    """Parse and validate one exposition document; raises
    :class:`ExpositionError` on the first violation."""
    exp = Exposition()
    seen: set = set()
    families_with_samples: set = set()
    for line_no, line in enumerate(text.splitlines(), start=1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4:
                raise ExpositionError(f"line {line_no}: malformed TYPE: {line!r}")
            _, _, family, kind = parts
            if kind not in ("counter", "gauge", "histogram", "summary", "untyped"):
                raise ExpositionError(
                    f"line {line_no}: unknown metric type {kind!r}"
                )
            if family in exp.types:
                raise ExpositionError(
                    f"line {line_no}: duplicate TYPE for {family}"
                )
            if family in families_with_samples:
                raise ExpositionError(
                    f"line {line_no}: TYPE for {family} after its samples"
                )
            exp.types[family] = kind
            continue
        if line.startswith("#"):
            continue  # HELP/comments
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ExpositionError(f"line {line_no}: unparseable sample: {line!r}")
        name = m.group("name")
        if not _NAME_RE.match(name):
            raise ExpositionError(f"line {line_no}: bad metric name {name!r}")
        labels = _parse_labels(m.group("labels") or "", line_no)
        try:
            value = float(m.group("value"))
        except ValueError:
            raise ExpositionError(
                f"line {line_no}: non-numeric value {m.group('value')!r}"
            )
        key = (name, labels)
        if key in seen:
            raise ExpositionError(f"line {line_no}: duplicate series {line!r}")
        seen.add(key)
        families_with_samples.add(_family_of(name))
        exp.samples.append(Sample(name, labels, value, line_no))
    _check_histograms(exp)
    return exp


def _check_histograms(exp: Exposition) -> None:
    """Bucket ordering/monotonicity + ``+Inf`` terminal == ``_count`` for
    every family declared ``histogram``."""
    for family, kind in exp.types.items():
        if kind != "histogram":
            continue
        # Group buckets by their non-le label set.
        groups: dict = {}
        sums: dict = {}
        counts: dict = {}
        for s in exp.samples:
            base = tuple(kv for kv in s.labels if kv[0] != "le")
            if s.name == f"{family}_bucket":
                le = dict(s.labels).get("le")
                if le is None:
                    raise ExpositionError(
                        f"line {s.line_no}: {family}_bucket without le label"
                    )
                groups.setdefault(base, []).append((s.line_no, le, s.value))
            elif s.name == f"{family}_sum":
                sums[base] = s.value
            elif s.name == f"{family}_count":
                counts[base] = s.value
        if not groups:
            raise ExpositionError(f"histogram {family} has no _bucket samples")
        for base, buckets in groups.items():
            ordered = sorted(buckets, key=lambda b: _le_key(b[1]))
            if [b[1] for b in buckets] != [b[1] for b in ordered]:
                raise ExpositionError(
                    f"{family}{dict(base)}: le buckets out of order"
                )
            if ordered[-1][1] != "+Inf":
                raise ExpositionError(
                    f"{family}{dict(base)}: missing terminal +Inf bucket"
                )
            prev = -1.0
            for _, _, value in ordered:
                if value < prev:
                    raise ExpositionError(
                        f"{family}{dict(base)}: bucket counts not monotonic"
                    )
                prev = value
            if base not in sums or base not in counts:
                raise ExpositionError(
                    f"{family}{dict(base)}: missing _sum/_count"
                )
            if counts[base] != ordered[-1][2]:
                raise ExpositionError(
                    f"{family}{dict(base)}: _count != +Inf bucket"
                )
