"""Math answer extraction + equivalence grading.

Re-implements the grading semantics of the reference parser
(reference: realhf/impl/dataset/math_parser.py:1-874 — answer extraction
from \\boxed{}/"answer is" clauses, latex normalization via ``strip_string``,
and the ``math_equal`` decision ladder: string match -> numeric match with
percent tolerance -> tuple/interval/matrix element-wise -> equation forms ->
sympy symbolic equivalence).  The reference leans on the vendored
latex2sympy2 + antlr ``parse_latex``; neither exists in this image, so the
latex -> sympy step is an in-house recursive-descent translator
(``_tex_to_expr_text``) feeding sympy's ``parse_expr`` with implicit
multiplication.  Agreement with the reference's labels is pinned by
``tests/data/test_math_parser.py`` against the reference fixture set
(reference: tests/reward/math_answers_sample_cases.jsonl).

Grading is CPU-side (never under jit); heavy sympy calls are bounded by a
SIGALRM deadline and by the process pool in areal_tpu/verifiers/math_verify.py.

The port's copy of ``areal_tpu/data/math_parser.py``,
its imports renamed to ``areal_tpu_torch``.
"""

from __future__ import annotations

import re
import signal
from math import isclose
from typing import List, Optional, Sequence, Union

from areal_tpu_torch.base import logging_

logger = logging_.getLogger("math_parser")

REL_TOL = 1e-4

# ---------------------------------------------------------------------------
# answer extraction
# ---------------------------------------------------------------------------


def _balanced_group(text: str, start: int) -> Optional[str]:
    """Content of the ``{...}`` group beginning at ``start`` (which must
    index the opening brace), honoring nesting; None if unterminated."""
    if start >= len(text) or text[start] != "{":
        return None
    depth = 0
    for i in range(start, len(text)):
        if text[i] == "{":
            depth += 1
        elif text[i] == "}":
            depth -= 1
            if depth == 0:
                return text[start + 1 : i]
    return None


def extract_boxed(text: str) -> Optional[str]:
    """Content of the LAST ``\\boxed{...}`` / ``boxed{...}`` in ``text``.

    The reference takes the last occurrence (``split("boxed")[-1]``,
    reference: realhf/impl/dataset/math_parser.py:372) because chain-of-
    thought often contains intermediate boxed values.
    """
    idx = text.rfind("boxed")
    if idx < 0:
        return None
    rest = text[idx + len("boxed") :]
    if not rest:
        return None
    rest = rest.lstrip()
    if rest.startswith("{"):
        return _balanced_group(rest, 0)
    # bare form: boxed 42$ ... take up to the next dollar sign
    return rest.split("$", 1)[0].strip()


def extract_answer(
    pred_str: str, use_last_number: bool = True
) -> Optional[str]:
    """Final-answer snippet from a full solution string, normalized.

    Mirrors the reference's extraction priority (reference:
    realhf/impl/dataset/math_parser.py:361-428): minerva-style
    "final answer is $..$. I hope" -> boxed -> "the answer is" ->
    "final answer is" -> (optionally) the last number in the string.
    Model-generated text is graded with ``use_last_number=False`` so a
    rambling solution with no explicit final answer scores 0.
    """
    pred_str = pred_str.replace("\u043a\u0438", "")  # stray cyrillic artifact
    pred = None
    if "final answer is $" in pred_str and "$. I hope" in pred_str:
        pred = pred_str.split("final answer is $", 1)[1].split("$. I hope", 1)[0]
    elif "boxed" in pred_str:
        pred = extract_boxed(pred_str) or ""
    elif "he answer is" in pred_str:
        pred = pred_str.split("he answer is")[-1]
    elif "final answer is" in pred_str:
        pred = pred_str.split("final answer is")[-1]
    elif use_last_number:
        nums = re.findall(r"-?\d*\.?\d+", pred_str.replace(",", ""))
        pred = nums[-1] if nums else ""
    if pred is None:
        return None
    pred = re.sub(r"\n\s*", "", pred).strip()
    pred = pred.lstrip(":").strip()
    pred = pred.rstrip(".").rstrip("/")
    return strip_answer_string(pred)


# ---------------------------------------------------------------------------
# normalization (the reference's strip_string role,
# reference: realhf/impl/dataset/math_parser.py:221-358)
# ---------------------------------------------------------------------------

# measurement words stripped from answers ("42 square feet" == "42"); the
# reference carries a MathQA-derived list of ~150; this covers the common
# physical/currency units plus counting nouns that appear in MATH answers
_UNIT_WORDS = [
    "degrees", "degree", "deg", "radians", "radian",
    "meters", "meter", "metres", "metre", "cm", "mm", "km", "m",
    "inches", "inch", "in", "feet", "foot", "ft", "yards", "yard", "miles",
    "mile", "mph", "kmph", "kmh",
    "seconds", "second", "sec", "minutes", "minute", "min", "hours", "hour",
    "hr", "days", "day", "weeks", "week", "months", "month", "years", "year",
    "am", "pm", "noon",
    "grams", "gram", "gm", "kg", "g", "lbs", "lb", "pounds", "pound", "tons",
    "liters", "liter", "litres", "litre", "gallons", "gallon", "gal", "cc",
    "dollars", "dollar", "cents", "cent", "rupees", "rupee", "rs",
    "percent", "per",
    "units", "unit", "square", "sq", "cubic", "cu", "cube",
    "apples", "apple", "coins", "coin", "men", "man", "women", "woman",
    "east", "west", "north", "south",
    "more", "less", "gain", "loss", "profit", "increase", "decrease",
    "acres", "acre", "hectares", "hectare", "ohm", "number", "ratio",
]

# multi-letter unit abbreviations that may sit DIRECTLY against a digit
# ("42km") without being mistakable for a variable product; single-letter
# symbols (m, g, s) are never in this list
_ADJ_UNITS = [
    "kmph", "kmh", "mph", "lbs", "hrs", "deg", "gal", "sec", "min",
    "km", "cm", "mm", "kg", "mg", "gm", "ml", "sq", "cu", "ft", "lb",
    "oz", "cc", "hr",
]
_ADJ_UNIT_RE = "(?:" + "|".join(_ADJ_UNITS) + ")"


def _strip_unit_words(s: str) -> str:
    """Drop measurement words ANCHORED TO A NUMBER ("42 sq miles" -> "42").

    The digit-adjacency requirement keeps algebraic answers intact: "m/2",
    "\\frac{m}{2}", "g(x)" all use unit-word letters as SYMBOLS and must
    not be eaten (a bare word-boundary rule mis-grades them).  A unit word
    that IS the whole answer (e.g. "east") also survives.

    A separator between the digit and the unit is REQUIRED: "2m" is the
    monomial 2*m, not "2 meters" — the reference's boundary rule
    (reference: realhf/impl/dataset/math_parser.py:267, ``(^|\\W)unit($|\\W)``)
    likewise leaves digit-adjacent letters alone.
    """
    for _ in range(3):  # chains: "42 cu. ft." needs repeated passes
        for w in _UNIT_WORDS:
            # number, a separator, then the unit: "42 miles", "7 p . m"
            t = re.sub(
                r"(\d)[\s.]+" + w + r"(?![a-zA-Z])", r"\1", s
            )
            # a unit word that IS the whole answer survives
            if t.strip(" {}()[].,"):
                s = t
        # digit-ADJACENT multi-letter units ("42km", "3.5sq"): only
        # unambiguous unit abbreviations — single letters stay
        # separator-required so "2m" remains the monomial 2*m
        # lookahead rejects letters AND digits/'(' so "2sec(x)" (secant),
        # "3min(2,4)" and "42km2" (km^2) survive
        t = re.sub(
            r"(\d)" + _ADJ_UNIT_RE + r"(?![a-zA-Z0-9(])", r"\1", s
        )
        if t.strip(" {}()[].,"):
            s = t
    return s


_SMALL_NUMS = {
    "zero": 0, "one": 1, "two": 2, "three": 3, "four": 4, "five": 5,
    "six": 6, "seven": 7, "eight": 8, "nine": 9, "ten": 10, "eleven": 11,
    "twelve": 12, "thirteen": 13, "fourteen": 14, "fifteen": 15,
    "sixteen": 16, "seventeen": 17, "eighteen": 18, "nineteen": 19,
    "twenty": 20, "thirty": 30, "forty": 40, "fifty": 50, "sixty": 60,
    "seventy": 70, "eighty": 80, "ninety": 90,
}


def _word_to_number(text: str) -> str:
    """Whole-string English number words -> digits ("twenty-three" -> "23").

    Plays the reference's word2number role (reference:
    realhf/impl/dataset/math_parser.py:213-218) for the common cases; a
    string that is not purely a number word phrase passes through unchanged.
    """
    words = re.split(r"[\s-]+", text.strip().lower())
    if not words or not all(
        w in _SMALL_NUMS or w in ("hundred", "thousand", "million", "and")
        for w in words
    ):
        return text
    total, chunk = 0, 0
    saw_num = False
    for w in words:
        if w == "and":
            continue
        if w in _SMALL_NUMS:
            chunk += _SMALL_NUMS[w]
            saw_num = True
        elif w == "hundred":
            chunk = max(chunk, 1) * 100
        else:  # thousand / million
            total += max(chunk, 1) * (1000 if w == "thousand" else 10**6)
            chunk = 0
    if not saw_num and total == 0:
        return text
    return str(total + chunk)


def _regroup_fracs(s: str) -> str:
    """Give every ``\\frac`` two brace-delimited arguments:
    ``\\frac12`` -> ``\\frac{1}{2}``, ``\\frac1{72}`` -> ``\\frac{1}{72}``.
    """
    out = []
    i = 0
    while True:
        j = s.find("\\frac", i)
        if j < 0:
            out.append(s[i:])
            break
        out.append(s[i:j])
        out.append("\\frac")
        k = j + len("\\frac")
        for _ in range(2):  # numerator then denominator
            if k < len(s) and s[k] == "{":
                grp = _balanced_group(s, k)
                if grp is None:
                    break
                out.append("{" + grp + "}")
                k += len(grp) + 2
            elif k < len(s):
                out.append("{" + s[k] + "}")
                k += 1
        i = k
    return "".join(out)


def strip_answer_string(s: str) -> str:
    """Canonicalize an extracted answer for comparison.

    Same normalization role as the reference's ``strip_string``
    (reference: realhf/impl/dataset/math_parser.py:221-358): kill layout
    latex, units, degree marks, currency, percent signs; canonicalize
    fractions/sqrt; drop a short "x =" prefix.
    """
    s = str(s).strip().replace("\n", "")
    s = s.rstrip(".")
    s = s.replace("\\!", "")
    # matrix environments: any array/bmatrix flavor compares as pmatrix
    s = re.sub(r"\\begin\{array\}\{[^}]*\}", r"\\begin{pmatrix}", s)
    s = s.replace("\\end{array}", "\\end{pmatrix}").replace("bmatrix", "pmatrix")
    s = s.replace("tfrac", "frac").replace("dfrac", "frac")
    s = s.replace("\\neq", "\\ne").replace("\\leq", "\\le").replace("\\geq", "\\ge")
    s = s.replace("\\left", "").replace("\\right", "")
    s = s.replace("\\{", "{").replace("\\}", "}")
    # trailing \text{...} is a unit annotation ("42 \text{ miles}")
    t = re.sub(r"\\text\{.*?\}$", "", s).strip()
    if t and t != s:
        s = t
    # inline \text{...} keeps its content ("\text{east}" -> "east") —
    # unwrapped BEFORE unit stripping so a text answer that happens to be a
    # unit word is preserved whole
    s = re.sub(r"\\text\{(.*?)\}", r"\1", s)
    s = _strip_unit_words(s)
    s = s.replace("^{\\circ}", "").replace("^\\circ", "")
    s = s.replace("\\$", "").replace("$", "")
    s = s.replace("\\(", "").replace("\\)", "")
    s = _word_to_number(s)
    # drop a variable-binding PREFIX only ("x=5" -> "5"); replacing these
    # anywhere would corrupt answers like "2x=4" (the short-lhs rule below
    # handles the general one-equals case)
    for prefix in ("x=", "y=", "z=", "x\\in", "y\\in", "z\\in",
                   "x\\to", "y\\to", "z\\to"):
        if s.startswith(prefix):
            s = s[len(prefix):]
    s = s.replace("\\emptyset", r"{}")
    s = s.replace("(-\\infty,\\infty)", "\\mathbb{R}")
    s = s.replace("\\%", "").replace("%", "")
    s = s.replace(" .", " 0.").replace("{.", "{0.")
    s = s.replace("infinity", "\\infty")
    if "\\infty" not in s:
        s = s.replace("inf", "\\infty")
    s = s.replace("and", "").replace("\\mathbf", "")
    s = re.sub(r"\\mbox\{.*?\}", "", s)
    if "j" in s and "i" not in s:
        s = s.replace("j", "i")  # imaginary unit spelling
    # trailing zero decimals: 2.0 -> 2, 5.000x -> 5x
    s = re.sub(r"(\d+)\.0*([^\d])", r"\1\2", s)
    s = re.sub(r"(\d+)\.0*$", r"\1", s)
    if not s:
        return s
    if s[0] == ".":
        s = "0" + s
    # "k = 7" -> "7" (short lhs only, so equations survive)
    parts = s.split("=")
    if len(parts) == 2 and len(parts[0]) <= 2:
        s = parts[1]
    s = re.sub(r"\\sqrt(\w+)", r"\\sqrt{\1}", s)
    s = s.replace(" ", "")
    s = _regroup_fracs(s)
    # bare integer ratio -> canonical frac
    m = re.fullmatch(r"(-?\d+)/(-?\d+)", s)
    if m:
        s = "\\frac{" + m.group(1) + "}{" + m.group(2) + "}"
    return s


# ---------------------------------------------------------------------------
# latex -> sympy (replaces the reference's latex2sympy2 / antlr parse_latex)
# ---------------------------------------------------------------------------

_TEX_FUNCS = {
    "sin", "cos", "tan", "cot", "sec", "csc", "arcsin", "arccos", "arctan",
    "sinh", "cosh", "tanh", "log", "exp", "min", "max", "gcd", "lcm",
}
_TEX_CONSTS = {"pi": "pi", "infty": "oo", "e": "E"}


def _read_tex_arg(s: str, i: int):
    """One latex argument starting at index ``i``: a brace group or a single
    character. Returns (content, next_index)."""
    if i < len(s) and s[i] == "{":
        grp = _balanced_group(s, i)
        if grp is not None:
            return grp, i + len(grp) + 2
    if i < len(s):
        return s[i], i + 1
    return "", i


def _tex_to_expr_text(s: str) -> str:
    """Translate latex-ish math into text sympy's parse_expr accepts.

    Handles nested \\frac, \\sqrt[n]{}, powers, subscripted symbols
    (``S_{\\triangle}`` -> ``S_triangle``), common functions/constants, and
    multiplication glyphs.  Unknown commands become bare symbol names so
    free-variable answers still compare structurally.
    """
    out: List[str] = []
    i = 0
    n = len(s)
    while i < n:
        c = s[i]
        if c == "\\":
            m = re.match(r"\\([a-zA-Z]+)", s[i:])
            if not m:
                i += 1  # lone backslash: drop
                continue
            cmd = m.group(1)
            i += m.end()
            if cmd == "frac":
                a, i = _read_tex_arg(s, i)
                b, i = _read_tex_arg(s, i)
                out.append(
                    f"(({_tex_to_expr_text(a)})/({_tex_to_expr_text(b)}))"
                )
            elif cmd == "sqrt":
                if i < n and s[i] == "[":
                    end = s.find("]", i)
                    root = s[i + 1 : end] if end > 0 else "2"
                    i = end + 1 if end > 0 else i + 1
                    a, i = _read_tex_arg(s, i)
                    out.append(
                        f"(({_tex_to_expr_text(a)})**(1/({_tex_to_expr_text(root)})))"
                    )
                else:
                    a, i = _read_tex_arg(s, i)
                    out.append(f"(sqrt({_tex_to_expr_text(a)}))")
            elif cmd in ("cdot", "times", "ast"):
                out.append("*")
            elif cmd == "div":
                out.append("/")
            elif cmd == "ln":
                out.append("log")
            elif cmd in _TEX_FUNCS:
                out.append(cmd)
            elif cmd in _TEX_CONSTS:
                out.append(_TEX_CONSTS[cmd])
            elif cmd in ("text", "mathrm", "operatorname", "mathit"):
                a, i = _read_tex_arg(s, i)
                out.append(re.sub(r"\W+", "", a))
            else:
                # greek letters and any unknown command -> symbol name
                out.append(cmd)
        elif c == "^":
            i += 1
            a, i = _read_tex_arg(s, i)
            out.append(f"**({_tex_to_expr_text(a)})")
        elif c == "_":
            i += 1
            a, i = _read_tex_arg(s, i)
            tag = re.sub(r"\W+", "", _tex_to_expr_text(a))
            # weld the subscript onto the preceding symbol: S_1 stays
            # distinct from S_2
            if out and re.search(r"[A-Za-z0-9]$", out[-1]):
                out.append("_" + tag if tag else "")
            else:
                out.append(tag)
        elif c == "{":
            grp = _balanced_group(s, i)
            if grp is None:
                i += 1
                continue
            i += len(grp) + 2
            out.append(f"({_tex_to_expr_text(grp)})")
        elif c == "!":
            # factorial: rewrite trailing atom
            prev = out[-1] if out else ""
            if prev and re.fullmatch(r"[\w.()]+", prev):
                out[-1] = f"factorial({prev})"
            i += 1
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _parse_symbolic(s: str):
    """Best-effort sympy expression (or Eq/Matrix) from an answer string;
    returns the raw string when nothing parses (string compare still runs)."""
    import sympy
    from sympy.parsing.sympy_parser import (
        convert_xor,
        implicit_multiplication_application,
        parse_expr,
        standard_transformations,
    )

    transforms = standard_transformations + (
        implicit_multiplication_application,
        convert_xor,
    )

    def _expr(text: str):
        return parse_expr(
            text, transformations=transforms, evaluate=True
        )

    for candidate in (s.replace("\\\\", "\\"), s):
        text = _tex_to_expr_text(candidate)
        try:
            if text.count("=") == 1:
                lhs, rhs = text.split("=")
                return sympy.Eq(_expr(lhs), _expr(rhs))
            return _expr(text)
        except Exception:
            continue
    return s


class _Deadline:
    """SIGALRM-scoped guard so a pathological sympy ``simplify`` cannot hang
    the grader (reference bounds this with a subprocess,
    reference: realhf/impl/dataset/math_parser.py:685-697; an alarm is far
    cheaper and composes with the outer process pool)."""

    def __init__(self, seconds: int = 5):
        self.seconds = seconds
        self.armed = False

    def __enter__(self):
        try:
            signal.signal(signal.SIGALRM, self._raise)
            signal.alarm(self.seconds)
            self.armed = True
        except ValueError:
            pass  # non-main thread: rely on the process-pool deadline
        return self

    @staticmethod
    def _raise(signum, frame):
        raise TimeoutError("math grading deadline")

    def __exit__(self, *exc):
        if self.armed:
            signal.alarm(0)
        return False


# ---------------------------------------------------------------------------
# equivalence ladder
# ---------------------------------------------------------------------------


def _parse_number(s) -> Optional[float]:
    """Float from a numeric answer, tolerating thousands separators and a
    trailing percent sign (``12.5\\%`` -> 0.125)."""
    text = str(s).replace(",", "")
    try:
        return float(text)
    except ValueError:
        pass
    if text.endswith("%"):
        text = text[:-1].rstrip("\\")
        try:
            return float(text) / 100.0
        except ValueError:
            pass
    return None


def _clean_choice(pred: str) -> str:
    """Extract a multiple-choice letter from a prose prediction.

    Matches on the RAW string: an uppercase standalone A-E, or a
    parenthesized letter of either case ("(c)").  Upper-casing first would
    turn the English article "a" into choice A.
    """
    pred = pred.strip("\n").rstrip(".").rstrip("/").strip().lstrip(":")
    # lowercase b-e are unambiguous as standalone words; lowercase "a" only
    # counts when parenthesized (else every English article grades as A)
    letters = [
        (m.group(1) or m.group(2)).upper()
        for m in re.finditer(r"\(([A-Ea-e])\)|\b([A-Eb-e])\b", pred)
    ]
    if letters:
        return letters[-1]
    return pred.strip().strip(".")


def _numeric_equal(a: float, b: float) -> bool:
    return isclose(a, b, rel_tol=REL_TOL)


def _symbolic_equal(a: str, b: str) -> bool:
    import sympy

    pa, pb = _parse_symbolic(a), _parse_symbolic(b)
    try:
        if pa == pb or str(pa) == str(pb):
            return True
    except Exception:
        pass
    try:
        if pa.equals(pb) or sympy.simplify(pa - pb) == 0:
            return True
    except Exception:
        pass
    try:  # both equations: compare |lhs-rhs| so scaling/sides don't matter
        if (abs(pa.lhs - pa.rhs)).equals(abs(pb.lhs - pb.rhs)):
            return True
    except Exception:
        pass
    try:
        if _numeric_equal(float(sympy.N(pa)), float(sympy.N(pb))):
            return True
    except Exception:
        pass
    return False


def _split_matrix_rows(s: str) -> Optional[List[List[str]]]:
    m = re.fullmatch(
        r"\\begin\{.matrix\}(.*)\\end\{.matrix\}", s.strip(), re.DOTALL
    )
    if not m:
        return None
    rows = [r.strip() for r in m.group(1).split("\\\\") if r.strip()]
    return [[c.strip() for c in r.split("&")] for r in rows]


def _braced_set_to_matrix(s: str) -> str:
    """``{a, b}`` -> pmatrix string, so a set-style reference can be compared
    against a pmatrix prediction (reference:
    realhf/impl/dataset/math_parser.py:431-441)."""
    groups = re.findall(r"\{.*?,.*?\}", s)
    mats = []
    for g in groups:
        body = g.strip("{}").replace(",", "\\\\")
        mats.append("\\begin{pmatrix}" + body + "\\end{pmatrix}")
    return ", ".join(mats) if mats else s


def math_equal(
    prediction: Union[bool, float, str],
    reference: Union[float, str],
    include_percentage: bool = True,
) -> bool:
    """The decision ladder (reference: realhf/impl/dataset/math_parser.py:
    496-682): lowercase string match; multiple-choice letters; numeric with
    x100/÷100 percent aliasing at 1e-4 relative tolerance; bracket-stripped
    match; element-wise tuples/intervals and matrices; equation rearrangement;
    finally sympy symbolic equivalence.
    """
    if prediction is None or reference is None:
        return False
    prediction, reference = str(prediction).strip(), str(reference).strip()
    if prediction.lower() == reference.lower():
        return True
    if reference in "ABCDE" and len(reference) == 1:
        if _clean_choice(prediction) == reference:
            return True

    pn, rn = _parse_number(prediction), _parse_number(reference)
    if pn is not None and rn is not None:
        aliases = [rn / 100, rn, rn * 100] if include_percentage else [rn]
        return any(_numeric_equal(pn, a) for a in aliases)

    if not prediction:
        return False

    # set-notation reference vs matrix prediction
    if "pmatrix" in prediction and "pmatrix" not in reference:
        reference = _braced_set_to_matrix(reference)

    # bracket-insensitive comparison: (1,2) vs [1,2], {x} vs x
    ps, rs = prediction, reference
    if (ps.startswith("[") and ps.endswith("]") and not rs.startswith("(")) or (
        ps.startswith("(") and ps.endswith(")") and not rs.startswith("[")
    ):
        ps, rs = ps.strip("[]()"), rs.strip("[]()")
    for ch in "{}()":
        ps, rs = ps.replace(ch, ""), rs.replace(ch, "")
    if ps.lower() == rs.lower():
        return True

    # element-wise tuples / intervals / coordinate pairs
    if (
        re.fullmatch(r"[\(\[].+[\)\]]", prediction)
        and re.fullmatch(r"[\(\[].+[\)\]]", reference)
    ):
        pp = prediction[1:-1].split(",")
        rp = reference[1:-1].split(",")
        if len(pp) == len(rp) and all(
            math_equal(x, y, include_percentage) for x, y in zip(pp, rp)
        ):
            return True

    # element-wise matrices
    pm, rm = _split_matrix_rows(prediction), _split_matrix_rows(reference)
    if pm is not None and rm is not None:
        if len(pm) == len(rm) and all(
            len(pr) == len(rr)
            and all(
                math_equal(x, y, include_percentage)
                for x, y in zip(pr, rr)
            )
            for pr, rr in zip(pm, rm)
        ):
            return True

    # equations: a=b vs c=d compare as (a-b) ~ ±(c-d); a one-sided short
    # "x = expr" collapses to its rhs
    if prediction.count("=") == 1 and reference.count("=") == 1:
        pl, pr_ = (t.strip() for t in prediction.split("="))
        rl, rr_ = (t.strip() for t in reference.split("="))
        pd, rd = f"{pl} - ({pr_})", f"{rl} - ({rr_})"
        if _symbolic_equal(pd, rd) or _symbolic_equal(f"-({pd})", rd):
            return True
    elif (
        prediction.count("=") == 1
        and len(prediction.split("=")[0].strip()) <= 2
        and "=" not in reference
    ):
        if math_equal(prediction.split("=")[1], reference, include_percentage):
            return True
    elif (
        reference.count("=") == 1
        and len(reference.split("=")[0].strip()) <= 2
        and "=" not in prediction
    ):
        if math_equal(prediction, reference.split("=")[1], include_percentage):
            return True

    return _symbolic_equal(prediction, reference)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def grade_answer(generated: str, solution: str) -> int:
    """1 if the generated text's final answer matches the solution's, else 0.

    The generated side must contain an explicit final answer (boxed or an
    "answer is" clause); the solution side may fall back to its last number
    (reference: realhf/impl/dataset/math_parser.py:760-785).
    """
    try:
        with _Deadline(5):
            pred = extract_answer(generated, use_last_number=False)
            ref = extract_answer(solution, use_last_number=True)
            if pred is None or pred.strip() in ("", "None", "none"):
                return 0
            if ref is None or ref.strip() in ("", "None", "none"):
                return 0
            return int(math_equal(pred, ref))
    except Exception:
        return 0


def verify_math_solution(
    generated: str, solutions: Union[str, Sequence[str]]
) -> float:
    """1.0 if the generated final answer matches ANY reference solution."""
    if isinstance(solutions, str):
        solutions = [solutions]
    return float(any(grade_answer(generated, sol) for sol in solutions))


def parse_lines_in_parallel(
    generateds: List[str], solutions_list: List[List[str]]
) -> List[float]:
    """Verify many answers concurrently with timeout isolation.  Delegates
    to the hardened process-pool wrapper (areal_tpu/verifiers/math_verify.py)
    so a pathological sympy input can never hang the caller."""
    from areal_tpu_torch.verifiers.math_verify import math_verify

    return math_verify(generateds, solutions_list)
