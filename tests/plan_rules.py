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


# ---- the carry: which blocks' delayed pass the next chain takes -----------
#
# csrc/panel_cluster.cuh `run_cluster` folds block j's delayed pass into
# chain j + 1's load (its own columns; the rest runs beside that chain)
# where blocks j and j + 1 both run their chain on the cluster, the form is
# the step-order or the sum-first one (not bf16x3), the plan has more than
# one block, b is at most kCarryMax, and the carry's shared memory fits
# beside the chain's own (kSmemMax).  ``carries`` mirrors that rule;
# ``CARRIED_PER_CALL`` pins what it gives for the cells' lu calls.

CARRY_MAX = 32  # kCarryMax
SMEM_MAX = 232448 - 1024  # kSmemMax
CARRY_RULE = ("if (kForm == kBf16x3 || pl.one_block || k1 >= steps || blk < pl.grid_blocks || "
              "pl.b > kCarryMax) return false;")
# chain launches a call that take the previous block's pass at load, in the
# benchmark cells' keys (every block of every panel but the panel's last)
CARRIED_PER_CALL = {("float32", 4096): 200, ("float32", 8192): 704, ("float64", 4096): 136}


def chain_smem_bytes(dtype_name, rows, C, B):
    """csrc/panel_cluster.cuh ``chain_smem<T>(rows, C, B, true).total``: the
    padded slab, the exchange's slots and candidates, the rows' perm ids and
    origins."""
    sz = ITEM_BYTES[dtype_name]
    cplx = dtype_name.startswith("complex")
    rpw = max(1, 128 // (min(B, 32) * sz))
    o = rows * B * sz + -(-rows // rpw) * sz
    o = (o + 15) & ~15
    o += 2 * C * B * sz + 2 * B * sz + (B * sz if cplx else 0)
    o += 2 * C * CAND_BYTES[dtype_name] + 16 + (8 if cplx else 0)
    return o + rows * 8


def carry_bytes(dtype_name, pnb, B, rows):
    """``carry_smem<T>(pnb, B, rows)``: the previous block's U rows in this
    block's columns, its L_jj and the CTA's slab rows' multipliers with a
    padded row, its U rows' origins."""
    return (pnb * B + (pnb + rows) * (pnb + 1)) * ITEM_BYTES[dtype_name] + pnb * 4


def slab_width(b):
    """The chain's slab width for blocks of b steps (b < w): b rounded up to
    a power of two, at least 8."""
    return max(8, 1 << (b - 1).bit_length())


def carries(dtype_name, m, w, b, C, blk, form="step", grid_blocks=0):
    """Does chain blk + 1 of an (m live rows, w) panel on plan (b, C) take
    block blk's delayed pass at load?"""
    k1 = (blk + 1) * b
    if form == "bf16x3" or b >= w or k1 >= min(m, w) or blk < grid_blocks or b > CARRY_MAX:
        return False
    B = slab_width(b)
    rows = -(-(m - k1) // C)
    return ((chain_smem_bytes(dtype_name, rows, C, B) + 15) & ~15) \
        + carry_bytes(dtype_name, b, B, rows) <= SMEM_MAX


def carried_blocks(dtype_name, m, w, b, C, form="step", grid_blocks=0):
    """The chain launches of one panel that take the previous block's pass."""
    blocks = -(-min(m, w) // b)
    return sum(carries(dtype_name, m, w, b, C, j, form, grid_blocks) for j in range(blocks - 1))


def lu_carried(dtype_name, n, w=WIDTH):
    """The same over the panels of a blocked lu at n (n - w k live rows, w
    columns), each on its auto plan."""
    total = 0
    for m in range(n, 0, -w):
        b, C = AUTO_PLANS[dtype_name].get(m) or rule_plan(rule_of(dtype_name), m, w)
        total += carried_blocks(dtype_name, m, min(w, m), b, C)
    return total


# ---- the blocked schedule's look-ahead: which panels split their trailing block
#
# ops/blocked.py `lookahead`: the panel at column s splits the columns past
# the next panel (its trailing block) from that panel's own (the strip),
# and on the card runs them beside the next panel's kernels, where the next
# step is a panel, not the recursive tail (taken with pivoting only), and
# columns lie past it.  ``lookahead_panels`` mirrors the count of one
# blocked lu; ``LOOKAHEAD_PER_CALL`` pins it in the benchmark cells' keys.


def lookahead(n, s, w=WIDTH, pivot=True, tail=None):
    """Does the panel at column s of an n-column blocked lu split its
    trailing block from the next panel's strip?"""
    nxt = s + w
    if pivot and tail is not None and n - nxt <= tail:
        return False
    return nxt + w < n


def lookahead_panels(n, w=WIDTH, pivot=True, tail=None):
    """The panels of one blocked lu of n columns that split their trailing
    block (the panels before the recursive tail)."""
    total = 0
    for s in range(0, n, w):
        if pivot and s > 0 and tail is not None and n - s <= tail:
            break
        total += lookahead(n, s, w, pivot, tail)
    return total


# per call in the cells' keys (panel width 512, no tail): the pivoted lu
# ("float32", "float64"), RBT's pivot-free factor ("rbt_float32"); the
# batched cell runs no blocked schedule
LOOKAHEAD_PER_CALL = {("float32", 4096): 6, ("float32", 8192): 14, ("float64", 4096): 6,
                      ("rbt_float32", 4096): 6, ("float32", 1536): 1, ("batched_float32", 64): 0}
