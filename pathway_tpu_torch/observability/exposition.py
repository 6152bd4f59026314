"""Own copy of ``pathway_tpu/observability/exposition.py`` (standard library
only).

Prometheus text-exposition (format 0.0.4) parser + validator.

The in-repo contract check for the `/metrics` endpoint: tier-1 scrapes
the monitoring server end-to-end and feeds the body through
``validate_exposition``, which enforces the conventions a real
Prometheus server (and promtool) would care about — sample syntax,
metric/label naming, one TYPE line per family, counters ending in
``_total``, histogram bucket monotonicity and ``_count``/``+Inf``
consistency, no duplicate (name, labelset) samples.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
_VALUE_RE = re.compile(
    r"^(?:[+-]?(?:\d+(?:\.\d*)?|\.\d+)(?:[eE][+-]?\d+)?|[+-]?Inf|NaN)$"
)


@dataclass
class Sample:
    name: str
    labels: dict[str, str]
    value: float
    line_no: int


@dataclass
class Family:
    name: str
    type: str = "untyped"
    help: str | None = None
    samples: list[Sample] = field(default_factory=list)


def _parse_labels(raw: str, line_no: int, errors: list[str]) -> dict[str, str]:
    """Parse `a="b",c="d"` honoring \\\\, \\" and \\n escapes."""
    labels: dict[str, str] = {}
    i = 0
    n = len(raw)
    while i < n:
        m = re.match(r"\s*([a-zA-Z_][a-zA-Z0-9_]*)\s*=\s*\"", raw[i:])
        if not m:
            errors.append(f"line {line_no}: malformed label pair at {raw[i:]!r}")
            return labels
        lname = m.group(1)
        i += m.end()
        buf = []
        while i < n:
            ch = raw[i]
            if ch == "\\":
                if i + 1 >= n:
                    errors.append(f"line {line_no}: dangling escape")
                    return labels
                nxt = raw[i + 1]
                if nxt == "n":
                    buf.append("\n")
                elif nxt in ('"', "\\"):
                    buf.append(nxt)
                else:
                    errors.append(
                        f"line {line_no}: invalid escape \\{nxt} in label "
                        f"{lname!r}"
                    )
                    buf.append(nxt)
                i += 2
            elif ch == '"':
                i += 1
                break
            elif ch == "\n":
                errors.append(f"line {line_no}: raw newline in label value")
                return labels
            else:
                buf.append(ch)
                i += 1
        else:
            errors.append(f"line {line_no}: unterminated label value")
            return labels
        if lname in labels:
            errors.append(f"line {line_no}: duplicate label {lname!r}")
        labels[lname] = "".join(buf)
        rest = raw[i:].lstrip()
        if rest.startswith(","):
            i = n - len(rest) + 1
        elif rest == "":
            break
        else:
            errors.append(f"line {line_no}: junk after label value: {rest!r}")
            return labels
    return labels


def _base_family(name: str) -> str:
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix):
            return name[: -len(suffix)]
    return name


def parse_exposition(
    text: str,
) -> tuple[dict[str, Family], list[str]]:
    """Parse exposition text into families; returns (families, errors)."""
    errors: list[str] = []
    families: dict[str, Family] = {}
    typed: dict[str, str] = {}

    def family_for(sample_name: str) -> Family:
        base = _base_family(sample_name)
        # _bucket/_sum/_count fold into the histogram family only when one
        # was declared; otherwise the sample is its own (untyped) family
        if base in typed and typed[base] in ("histogram", "summary"):
            key = base
        else:
            key = sample_name
        fam = families.get(key)
        if fam is None:
            fam = families[key] = Family(key)
            fam.type = typed.get(key, "untyped")
        return fam

    for line_no, line in enumerate(text.splitlines(), start=1):
        if not line.strip():
            continue
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) < 3 or (len(parts) < 4 and parts[1] == "TYPE"):
                errors.append(f"line {line_no}: malformed {parts[1]} line")
                continue
            kind, mname = parts[1], parts[2]
            if not _NAME_RE.match(mname):
                errors.append(
                    f"line {line_no}: invalid metric name {mname!r}"
                )
                continue
            if kind == "TYPE":
                mtype = parts[3].strip()
                if mtype not in (
                    "counter", "gauge", "histogram", "summary", "untyped"
                ):
                    errors.append(
                        f"line {line_no}: unknown type {mtype!r} for {mname}"
                    )
                if mname in typed:
                    errors.append(
                        f"line {line_no}: duplicate TYPE line for {mname}"
                    )
                typed[mname] = mtype
                fam = families.get(mname)
                if fam is None:
                    families[mname] = Family(mname, type=mtype)
                else:
                    if fam.samples:
                        errors.append(
                            f"line {line_no}: TYPE for {mname} after its "
                            "samples"
                        )
                    fam.type = mtype
            else:
                helptext = parts[3] if len(parts) > 3 else ""
                fam = families.setdefault(mname, Family(mname))
                if fam.help is not None:
                    errors.append(
                        f"line {line_no}: duplicate HELP line for {mname}"
                    )
                fam.help = helptext
            continue
        if line.startswith("#"):
            continue  # plain comment
        m = re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)(?:\s+(-?\d+))?\s*$", line)
        if not m:
            errors.append(f"line {line_no}: unparseable sample: {line!r}")
            continue
        name, rawlabels, rawvalue = m.group(1), m.group(2), m.group(3)
        labels = (
            _parse_labels(rawlabels, line_no, errors) if rawlabels else {}
        )
        for ln in labels:
            if not _LABEL_RE.match(ln):
                errors.append(f"line {line_no}: invalid label name {ln!r}")
        if not _VALUE_RE.match(rawvalue):
            errors.append(f"line {line_no}: invalid value {rawvalue!r}")
            continue
        value = float(rawvalue.replace("Inf", "inf"))
        family_for(name).samples.append(Sample(name, labels, value, line_no))
    return families, errors


def validate_exposition(text: str) -> list[str]:
    """Full conformance check; returns a list of violations (empty = ok)."""
    families, errors = parse_exposition(text)
    seen_samples: set[tuple[str, tuple[tuple[str, str], ...]]] = set()
    for fam in families.values():
        for s in fam.samples:
            key = (s.name, tuple(sorted(s.labels.items())))
            if key in seen_samples:
                errors.append(
                    f"line {s.line_no}: duplicate sample {s.name} "
                    f"{dict(key[1])}"
                )
            seen_samples.add(key)
        if fam.type == "counter":
            if not fam.name.endswith("_total"):
                errors.append(
                    f"counter {fam.name} should end in _total"
                )
            for s in fam.samples:
                if s.value < 0:
                    errors.append(
                        f"line {s.line_no}: counter {fam.name} is negative"
                    )
        if fam.type == "histogram":
            errors.extend(_check_histogram(fam))
    return errors


def _check_histogram(fam: Family) -> list[str]:
    errors: list[str] = []
    by_labelset: dict[tuple, dict[str, list[Sample]]] = {}
    for s in fam.samples:
        labels = {k: v for k, v in s.labels.items() if k != "le"}
        key = tuple(sorted(labels.items()))
        slot = by_labelset.setdefault(
            key, {"bucket": [], "sum": [], "count": []}
        )
        if s.name == fam.name + "_bucket":
            slot["bucket"].append(s)
        elif s.name == fam.name + "_sum":
            slot["sum"].append(s)
        elif s.name == fam.name + "_count":
            slot["count"].append(s)
        else:
            errors.append(
                f"line {s.line_no}: unexpected sample {s.name} in "
                f"histogram {fam.name}"
            )
    for key, slot in by_labelset.items():
        label_desc = dict(key) or "{}"
        if not slot["bucket"]:
            errors.append(f"{fam.name}{label_desc}: no _bucket samples")
            continue
        if len(slot["sum"]) != 1 or len(slot["count"]) != 1:
            errors.append(
                f"{fam.name}{label_desc}: needs exactly one _sum and one "
                "_count"
            )
            continue
        buckets: list[tuple[float, float, int]] = []
        has_inf = False
        for s in slot["bucket"]:
            le = s.labels.get("le")
            if le is None:
                errors.append(
                    f"line {s.line_no}: _bucket sample without le label"
                )
                continue
            if le == "+Inf":
                has_inf = True
                bound = float("inf")
            else:
                try:
                    bound = float(le)
                except ValueError:
                    errors.append(
                        f"line {s.line_no}: unparseable le={le!r}"
                    )
                    continue
            buckets.append((bound, s.value, s.line_no))
        if not has_inf:
            errors.append(f"{fam.name}{label_desc}: missing +Inf bucket")
        buckets.sort(key=lambda b: b[0])
        prev = None
        for bound, cum, line_no in buckets:
            if prev is not None and cum < prev:
                errors.append(
                    f"line {line_no}: {fam.name}{label_desc} bucket counts "
                    f"not monotone at le={bound}"
                )
            prev = cum
        if has_inf and buckets:
            inf_count = buckets[-1][1]
            total = slot["count"][0].value
            if inf_count != total:
                errors.append(
                    f"{fam.name}{label_desc}: +Inf bucket {inf_count} != "
                    f"_count {total}"
                )
    return errors
