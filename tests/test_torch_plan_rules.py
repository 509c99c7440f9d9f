"""The cluster route's auto rule (csrc/panel_cluster.cuh ``Auto<T>``) on the
CPU: the header's rules, read from the source, give the pinned (b, C) of
tests/plan_rules.py at the heights a blocked lu factors, for float32,
float64 and both complex types; the float32 and complex rules keep their
values.  The card test of ``panel_plan`` holds the compiled launcher to the
same table."""

import pytest

from plan_rules import AUTO_PLANS, ELEMENT, header_rules, rule_of, rule_plan


def test_the_header_holds_a_generic_rule_one_per_complex_element_and_one_for_float64():
    rules = header_rules()
    assert rules["T"] == (1536, 4096, 128, 32)
    assert rules["float2"] == rules["double2"] == (512, 4096, 128, 32)
    assert rules["double"] == (3584, 4096, 128, 32)
    assert set(rules) == {"T", "float2", "double2", "double"}  # float32: the generic rule


@pytest.mark.parametrize("dtype,m", [(d, m) for d in sorted(AUTO_PLANS) for m in AUTO_PLANS[d]])
def test_the_rule_gives_the_pinned_plan(dtype, m):
    assert rule_plan(rule_of(dtype), m) == AUTO_PLANS[dtype][m]


def test_a_rule_of_its_own_takes_precedence_over_the_generic_one():
    text = ("template <typename T, typename K = SwapChain<T>> struct Auto {\n"
            "  static constexpr AutoRule rule{1536, 4096, "
            "128, 32};\n};\ntemplate <> struct Auto<double> {\n  static constexpr AutoRule "
            "rule{4096, 4096, 128, 64};\n};\n")
    rules = header_rules(text)
    assert rule_of("float64", rules) == (4096, 4096, 128, 64)
    assert rule_of("float32", rules) == (1536, 4096, 128, 32)
    assert rule_plan(rules["double"], 4096) == (32, 16)
    assert rule_plan(rules["double"], 512) == (32, 8)
    assert set(ELEMENT) == set(AUTO_PLANS)


@pytest.mark.parametrize("m,w,want", [(100, 512, (32, 1)), (128, 512, (32, 1)),
                                      (129, 512, (32, 8)), (4096, 16, (16, 16)),
                                      (20000, 512, (8, 16))])
def test_rule_plan_follows_plan_for(m, w, want):
    # one CTA up to 128 rows, then the smallest power of two with at most
    # 32 rows a CTA, at most 16; one block when w <= b
    assert rule_plan((1536, 4096, 128, 32), m, w) == want
