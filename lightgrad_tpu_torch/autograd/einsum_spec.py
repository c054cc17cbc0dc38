"""Einsum spec parsing + gradient planning (copied from
``lightgrad_tpu/autograd/einsum_spec.py``: pure Python, no backend).

The backward of ``einsum`` is itself an einsum: the gradient of operand i
contracts the output gradient with every *other* operand, producing the
subset of operand i's indices that appear elsewhere; indices private to
operand i (summed in the forward, e.g. the 'a' of ``"ab->b"``) receive a
broadcast gradient.  The plan is implemented on the tape so every backend
shares it.

Restrictions (asserted with messages): explicit ``->`` output, no ellipsis,
no repeated index within one term (diagonals).
"""

__all__ = ["parse_spec", "bwd_plan"]


def parse_spec(spec: str, n_operands: int):
    """Validate ``spec`` for ``n_operands`` inputs -> (terms, out_term)."""
    s = spec.replace(" ", "")
    assert "->" in s, f"einsum spec {spec!r} must name its output ('->')"
    lhs, out = s.split("->")
    terms = lhs.split(",")
    assert len(terms) == n_operands, (
        f"einsum spec {spec!r} names {len(terms)} operands, got {n_operands}")
    for t in terms + [out]:
        assert "." not in t, f"ellipsis not supported in {spec!r}; spell out indices"
        assert t.isalpha() or t == "", f"bad index letters in {spec!r}"
    for t in terms:
        assert len(set(t)) == len(t), (
            f"repeated index within one term ({t!r}) -- diagonals not supported")
    assert len(set(out)) == len(out), f"repeated output index in {spec!r}"
    known = set("".join(terms))
    assert set(out) <= known, f"output index of {spec!r} missing from inputs"
    return terms, out


def bwd_plan(terms, out, i):
    """Gradient plan for operand ``i``: returns ``(sub_spec, kept, term)``.

    ``sub_spec`` is the einsum contracting ``(out_grad, *other_operands)``;
    it yields the indices of operand i that appear in the output or another
    operand (``kept``, in operand-i order).  Indices of operand i in neither
    place were pure reductions in the forward -- the caller re-inserts them
    as broadcast axes.
    """
    target = terms[i]
    others = [t for j, t in enumerate(terms) if j != i]
    avail = set(out) | set("".join(others))
    kept = "".join(c for c in target if c in avail)
    sub = ",".join([out] + others) + "->" + kept
    return sub, kept, target
