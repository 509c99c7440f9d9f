"""The cluster route's own choice of block width b and cluster size C for a
panel of 512 columns, as csrc/panel_cluster.cuh's ``Auto<T>`` rules give it
at the heights a blocked ``lu`` factors (n - 512 k live rows), pinned by
element type.  Shared by the CPU test of the header's rules
(tests/test_torch_plan_rules.py) and the card test of ``panel_plan``
(tests/test_torch_cuda.py); imports neither JAX nor the port.
"""

import re
from pathlib import Path

HEADER = (Path(__file__).resolve().parents[1] / "recursivefactorization_jl_tpu_torch"
          / "csrc" / "panel_cluster.cuh")
WIDTH = 512
MAX_CLUSTER = 16  # kMaxCluster

# (b, C) by live rows at 512 columns: float32 and the complex types keep
# the rules the earlier sweeps set; float64 takes b = 32 up to 3584 rows, as
# its own sweep at 512..4096 rows found (PERF.md)
AUTO_PLANS = {
    "float32": {512: (32, 16), 1024: (32, 16), 1536: (32, 16), 2048: (16, 16), 2560: (16, 16),
                3072: (16, 16), 3584: (16, 16), 4096: (16, 16), 8192: (8, 16)},
    "float64": {512: (32, 16), 1024: (32, 16), 1536: (32, 16), 2048: (32, 16), 2560: (32, 16),
                3072: (32, 16), 3584: (32, 16), 4096: (16, 16), 8192: (8, 16)},
    "complex64": {512: (32, 16), 1024: (16, 16), 1536: (16, 16), 2048: (16, 16),
                  2560: (16, 16), 3072: (16, 16), 3584: (16, 16), 4096: (16, 16)},
    "complex128": {512: (32, 16), 1024: (16, 16), 1536: (16, 16), 2048: (16, 16),
                   2560: (16, 16), 3072: (16, 16), 3584: (16, 16), 4096: (16, 16)},
}
# the element type of each torch dtype in the header's templates
ELEMENT = {"float32": "float", "float64": "double", "complex64": "float2",
           "complex128": "double2"}


def header_rules(text=None):
    """``{element: (b32_rows, b16_rows, one_cta_rows, rows_per_cta)}`` of the
    header's ``Auto`` rules of the swap chain; the generic one under
    ``"T"``."""
    text = HEADER.read_text() if text is None else text
    rules = {}
    pat = re.compile(r"struct\s+Auto\s*(?:<\s*(\w+)\s*>)?\s*\{"
                     r"\s*static\s+constexpr\s+AutoRule\s+rule\s*\{([^}]*)\}")
    for m in pat.finditer(text):
        rules[m.group(1) or "T"] = tuple(int(v) for v in m.group(2).split(","))
    return rules


def rule_plan(rule, m, w=WIDTH):
    """(b, C) that ``plan_for``'s auto branch takes for m live rows by
    ``rule``, where that plan fits the card (it does at 512 columns up to
    8192 rows for every element type: tests/test_torch_cuda.py checks the
    card's own plans against AUTO_PLANS)."""
    b32_rows, b16_rows, one_cta_rows, rows_per_cta = rule
    c = 1
    while m > one_cta_rows and c < MAX_CLUSTER and rows_per_cta * c < m:
        c *= 2
    b = 32 if m <= b32_rows else 16 if m <= b16_rows else 8
    return (w if w <= b else b), c


def rule_of(dtype_name, rules=None):
    rules = header_rules() if rules is None else rules
    return rules.get(ELEMENT[dtype_name], rules["T"])


# ---- the chain's exchange: bytes a CTA receives in a step ------------------
#
# csrc/panel_cluster.cuh `chain_exchange_bytes` arms each CTA's mbarrier of
# the step's parity with what it will receive; a count that disagrees with
# what is sent traps (or, without the bound, spins).  ``EXCHANGE_RULE`` pins
# its body (whitespace aside) and ``exchange_bytes`` mirrors it.

# bytes of an element and of a candidate (`Cand<R>`: the magnitude, row,
# perm id and origin; 16 with a float magnitude, 24 with a double one)
ITEM_BYTES = {"float32": 4, "float64": 8, "complex64": 8, "complex128": 16}
CAND_BYTES = {"float32": 16, "float64": 24, "complex64": 16, "complex128": 24}
EXCHANGE_RULE = (
    "const int holders = (M + rows - 1) / rows; "
    "const int live = (holders < C ? holders : C) - kk / rows; "
    "const size_t row = static_cast<size_t>(B) * sizeof(T); "
    "return static_cast<unsigned>(C * sizeof(Cand<typename Elem<T>::real>) + row + 8 + "
    "(pivot ? live * row : 0));")


def header_exchange_rule(text=None):
    """The body of the header's ``chain_exchange_bytes``, comments dropped
    and whitespace collapsed."""
    text = HEADER.read_text() if text is None else text
    m = re.search(r"chain_exchange_bytes\([^)]*\)\s*\{(.*?)\n\}", text, re.S)
    return " ".join(re.sub(r"//[^\n]*", "", m.group(1)).split()) if m else None


def exchange_bytes(dtype_name, M, rows, C, B, kk, pivot):
    """What a chain CTA of a cluster of C receives in step kk of a block of
    M slab rows, ``rows`` per CTA, slab width B: every CTA's candidate, with
    pivoting the candidate row of every CTA holding a slab row >= kk, and
    row kk with its (perm id, origin)."""
    holders = -(-M // rows)
    live = min(holders, C) - kk // rows
    row = B * ITEM_BYTES[dtype_name]
    return C * CAND_BYTES[dtype_name] + row + 8 + (live * row if pivot else 0)
