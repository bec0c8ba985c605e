"""Sum-formula and adduct parsing/arithmetic.

The reference delegates formula parsing to ``pyMSpec.pyisocalc`` inside
``sm/engine/isocalc_wrapper.py::IsocalcWrapper.isotope_peaks`` [U] (SURVEY.md
#6); adduct strings like ``+H``/``+Na``/``-H`` come straight from the
per-dataset config (``isotope_generation.adducts``).  We implement parsing
natively: a sum formula is a flat dict ``{element: count}``; adducts add or
remove atoms before isotope-pattern computation.
"""

from __future__ import annotations

import re

from . import elements


class FormulaError(ValueError):
    """Raised on unparseable formulas/adducts or unknown elements."""


def parse_formula(formula: str) -> dict[str, int]:
    """Parse a sum formula like ``C6H12O6`` or ``Ca(NO3)2`` into {element: count}.

    Raises FormulaError on syntax errors or elements missing from the isotope
    table (the reference behaves the same way: pyisocalc raises on unknown
    elements and the job skips/fails that formula).
    """
    if not formula or not isinstance(formula, str):
        raise FormulaError(f"empty or non-string formula: {formula!r}")
    counts: dict[str, int] = {}
    stack: list[dict[str, int]] = [counts]
    i = 0
    while i < len(formula):
        ch = formula[i]
        if ch == "(":
            stack.append({})
            i += 1
        elif ch == ")":
            if len(stack) == 1:
                raise FormulaError(f"unbalanced ')' in {formula!r}")
            group = stack.pop()
            m = re.match(r"\d+", formula[i + 1:])
            mult = int(m.group(0)) if m else 1
            if m and mult == 0:
                raise FormulaError(f"zero group count in {formula!r}")
            i += 1 + (m.end() if m else 0)
            for el, n in group.items():
                stack[-1][el] = stack[-1].get(el, 0) + n * mult
        else:
            m = re.match(r"([A-Z][a-z]?)(\d*)", formula[i:])
            if not m:
                raise FormulaError(f"cannot parse {formula!r} at position {i}")
            el = m.group(1)
            if not elements.is_known(el):
                raise FormulaError(f"unknown element {el!r} in {formula!r}")
            n = int(m.group(2)) if m.group(2) else 1
            if n == 0:
                raise FormulaError(f"zero count for {el!r} in {formula!r}")
            stack[-1][el] = stack[-1].get(el, 0) + n
            i += m.end()
    if len(stack) != 1:
        raise FormulaError(f"unbalanced '(' in {formula!r}")
    if not counts:
        raise FormulaError(f"empty formula {formula!r}")
    return counts


def parse_adduct(adduct: str) -> tuple[int, dict[str, int]]:
    """Parse an adduct string ``+H``, ``-H``, ``+Na`` -> (sign, {element: count})."""
    if not adduct or adduct[0] not in "+-":
        raise FormulaError(f"adduct must start with '+' or '-': {adduct!r}")
    sign = 1 if adduct[0] == "+" else -1
    atoms = parse_formula(adduct[1:])
    return sign, atoms


def apply_adduct(counts: dict[str, int], adduct: str) -> dict[str, int]:
    """Return atom counts of formula+adduct; raises if subtraction goes negative."""
    sign, atoms = parse_adduct(adduct)
    out = dict(counts)
    for el, n in atoms.items():
        c = out.get(el, 0) + sign * n
        if c < 0:
            raise FormulaError(f"adduct {adduct!r} removes more {el} than present")
        if c == 0:
            out.pop(el, None)
        else:
            out[el] = c
    if not out:
        raise FormulaError(f"adduct {adduct!r} empties the formula")
    return out


def format_formula(counts: dict[str, int]) -> str:
    """Hill-system formatting: with carbon, C then H then alphabetical;
    without carbon, strictly alphabetical (so HCl formats as 'ClH')."""
    if "C" in counts:
        keys = sorted(counts, key=lambda el: (el != "C", el != "H", el))
    else:
        keys = sorted(counts)
    return "".join(f"{el}{counts[el] if counts[el] != 1 else ''}" for el in keys)


def monoisotopic_mass(counts: dict[str, int]) -> float:
    return sum(elements.monoisotopic_mass(el) * n for el, n in counts.items())


def ion_mz(counts: dict[str, int], charge: int) -> float:
    """m/z of the monoisotopic ion at the given (signed, nonzero) charge."""
    if charge == 0:
        raise FormulaError("charge must be nonzero for an ion")
    m = monoisotopic_mass(counts) - charge * elements.ELECTRON_MASS
    return m / abs(charge)
