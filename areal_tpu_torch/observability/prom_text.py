"""Strict Prometheus text-exposition (0.0.4) parser.

Used by the master-side aggregator to consume worker ``/metrics`` pages and
by tests to validate the renderer — a lenient parser would let a malformed
exposition (which a real Prometheus server rejects) slip through CI, so
this one raises :class:`PromParseError` on anything out of spec:

* every sample must belong to a ``# TYPE``-declared family (histogram
  samples via their ``_bucket``/``_sum``/``_count`` suffixes),
* duplicate (name, labels) samples are errors,
* histogram bucket counts must be cumulative with ``le`` and the ``+Inf``
  bucket must equal ``_count``.

The port's copy of ``areal_tpu/observability/prom_text.py``,
its imports renamed to ``areal_tpu_torch``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_TYPES = ("counter", "gauge", "histogram", "summary", "untyped")
_HIST_SUFFIXES = ("_bucket", "_sum", "_count")


class PromParseError(ValueError):
    pass


@dataclasses.dataclass
class Sample:
    name: str  # full sample name, including any _bucket/_sum/_count suffix
    labels: Dict[str, str]
    value: float


@dataclasses.dataclass
class Family:
    name: str
    type: str
    help: str = ""
    samples: List[Sample] = dataclasses.field(default_factory=list)

    def series(
        self, suffix: str = "", **labels: str
    ) -> Optional[float]:
        """Value of the sample with exactly these labels, or None."""
        want = {k: str(v) for k, v in labels.items()}
        for s in self.samples:
            if s.name == self.name + suffix and s.labels == want:
                return s.value
        return None


def _parse_labels(body: str, line_no: int) -> Dict[str, str]:
    labels: Dict[str, str] = {}
    i = 0
    n = len(body)
    while i < n:
        m = re.match(r"[a-zA-Z_][a-zA-Z0-9_]*", body[i:])
        if not m:
            raise PromParseError(f"line {line_no}: bad label name at {body[i:]!r}")
        key = m.group(0)
        i += len(key)
        if i >= n or body[i] != "=":
            raise PromParseError(f"line {line_no}: expected '=' after {key}")
        i += 1
        if i >= n or body[i] != '"':
            raise PromParseError(f"line {line_no}: label value must be quoted")
        i += 1
        out = []
        while i < n and body[i] != '"':
            c = body[i]
            if c == "\\":
                if i + 1 >= n:
                    raise PromParseError(f"line {line_no}: dangling escape")
                nxt = body[i + 1]
                out.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt))
                if out[-1] is None:
                    raise PromParseError(
                        f"line {line_no}: bad escape \\{nxt}"
                    )
                i += 2
                continue
            out.append(c)
            i += 1
        if i >= n:
            raise PromParseError(f"line {line_no}: unterminated label value")
        i += 1  # closing quote
        if key in labels:
            raise PromParseError(f"line {line_no}: duplicate label {key}")
        labels[key] = "".join(out)
        if i < n:
            if body[i] != ",":
                raise PromParseError(
                    f"line {line_no}: expected ',' between labels"
                )
            i += 1
    return labels


def _parse_value(tok: str, line_no: int) -> float:
    if tok in ("+Inf", "Inf"):
        return float("inf")
    if tok == "-Inf":
        return float("-inf")
    if tok == "NaN":
        return float("nan")
    try:
        return float(tok)
    except ValueError:
        raise PromParseError(f"line {line_no}: bad value {tok!r}") from None


def _family_of(sample_name: str, families: Dict[str, Family]) -> Optional[Family]:
    fam = families.get(sample_name)
    if fam is not None and fam.type not in ("histogram", "summary"):
        return fam
    for suffix in _HIST_SUFFIXES:
        if sample_name.endswith(suffix):
            base = families.get(sample_name[: -len(suffix)])
            if base is not None and base.type in ("histogram", "summary"):
                return base
    # a histogram family name with no suffix is not a valid sample
    if fam is not None:
        raise PromParseError(
            f"sample {sample_name} hits a {fam.type} family without a "
            "_bucket/_sum/_count suffix"
        )
    return None


def parse(text: str) -> Dict[str, Family]:
    """Parse one exposition page into {family_name: Family}."""
    families: Dict[str, Family] = {}
    seen: set = set()
    for line_no, raw in enumerate(text.split("\n"), start=1):
        line = raw.rstrip("\r")
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                kind, name = parts[1], parts[2]
                if not _NAME_RE.match(name):
                    raise PromParseError(
                        f"line {line_no}: bad metric name {name!r}"
                    )
                if kind == "TYPE":
                    mtype = parts[3].strip() if len(parts) > 3 else ""
                    if mtype not in _TYPES:
                        raise PromParseError(
                            f"line {line_no}: unknown type {mtype!r}"
                        )
                    if name in families and families[name].samples:
                        raise PromParseError(
                            f"line {line_no}: TYPE for {name} after samples"
                        )
                    fam = families.setdefault(name, Family(name, mtype))
                    fam.type = mtype
                else:
                    fam = families.setdefault(name, Family(name, "untyped"))
                    fam.help = parts[3] if len(parts) > 3 else ""
                continue
            continue  # plain comment
        # sample line: name[{labels}] value [timestamp]
        m = re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)", line)
        if not m:
            raise PromParseError(f"line {line_no}: bad sample line {line!r}")
        sname = m.group(1)
        rest = line[len(sname):]
        labels: Dict[str, str] = {}
        if rest.startswith("{"):
            end = rest.rfind("}")
            if end < 0:
                raise PromParseError(f"line {line_no}: unterminated labels")
            labels = _parse_labels(rest[1:end], line_no)
            rest = rest[end + 1:]
        toks = rest.split()
        if len(toks) not in (1, 2):
            raise PromParseError(
                f"line {line_no}: expected value [timestamp], got {rest!r}"
            )
        value = _parse_value(toks[0], line_no)
        fam = _family_of(sname, families)
        if fam is None:
            raise PromParseError(
                f"line {line_no}: sample {sname} has no # TYPE declaration"
            )
        key = (sname, tuple(sorted(labels.items())))
        if key in seen:
            raise PromParseError(
                f"line {line_no}: duplicate sample {sname}{labels}"
            )
        seen.add(key)
        fam.samples.append(Sample(sname, labels, value))
    for fam in families.values():
        if fam.type == "histogram":
            _check_histogram(fam)
    return families


def _check_histogram(fam: Family):
    by_base: Dict[Tuple, Dict[str, float]] = {}
    counts: Dict[Tuple, float] = {}
    for s in fam.samples:
        base = tuple(
            sorted((k, v) for k, v in s.labels.items() if k != "le")
        )
        if s.name == fam.name + "_bucket":
            if "le" not in s.labels:
                raise PromParseError(
                    f"{fam.name}_bucket sample missing 'le' label"
                )
            by_base.setdefault(base, {})[s.labels["le"]] = s.value
        elif s.name == fam.name + "_count":
            counts[base] = s.value
    for base, buckets in by_base.items():
        def le_key(le: str) -> float:
            return float("inf") if le == "+Inf" else float(le)

        ordered = sorted(buckets.items(), key=lambda kv: le_key(kv[0]))
        prev = -1.0
        for le, v in ordered:
            if v < prev:
                raise PromParseError(
                    f"{fam.name}: bucket counts not cumulative at le={le}"
                )
            prev = v
        if "+Inf" not in buckets:
            raise PromParseError(f"{fam.name}: histogram missing +Inf bucket")
        if base in counts and buckets["+Inf"] != counts[base]:
            raise PromParseError(
                f"{fam.name}: +Inf bucket != _count for labels {dict(base)}"
            )
