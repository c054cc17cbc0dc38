"""The whole-stack decode kernel's schedule (``ops.decode_stack.plan_stack``
and ``stack_smem``, the rule ``csrc/decode_stack.cu`` follows, which the
card tests hold against the kernel's own) on the CPU: every output column
of every product and every visible cache row of every (row, head) is owned
by exactly one block, the blocks' shares differ by at most one tile, every
shape ``stack_supported`` admits fits the card's shared memory, and the
chunked attention merged as the kernel merges it (a block's chunks of a
pair folded online, partials merged in block order with the in-flight
rows) equals softmax attention."""

import numpy as np
import pytest

from lightgrad_tpu_torch.ops.decode_stack import (plan_stack, stack_smem,
                                                  stack_supported)

N_SM = 132  # an H100's SMs: the kernel's grid
W = 1024


def _ranges_tile(blocks, key, total, ve):
    """The blocks' [c0, c1) ranges of ``key`` tile [0, total) in order, in
    whole ve-column vectors."""
    at = 0
    for e in blocks:
        c0, c1 = e[key]
        assert c0 == at and c1 >= c0 and c0 % ve == 0 and c1 % ve == 0
        at = c1
    assert at == total


@pytest.mark.parametrize("wbytes", [1, 2, 4])
@pytest.mark.parametrize("d", [64, 768, 1024, 1600, 4096])
def test_plan_covers_every_column_once(d, wbytes):
    blocks = plan_stack(1, d, 4, d // 64, W, [100], N_SM, wbytes,
                        batched=False)
    assert len(blocks) == N_SM
    ve = 16 // wbytes
    _ranges_tile(blocks, "qkv", 3 * d, ve)
    _ranges_tile(blocks, "proj", d, ve)
    _ranges_tile(blocks, "fc", 4 * d, ve)
    _ranges_tile(blocks, "resid", d, 4)


@pytest.mark.parametrize("batched,positions", [
    (False, [0]), (False, [1]), (False, [512]), (False, [1023]),
    (False, [5000]),                          # past W: the whole window
    (True, [0]), (True, [0, 5, 37, 100, 511, 1000, 1023, 17]),
    (True, [32, 33, 31, 64]), (True, [W, W + 7, 0]),
    (True, [9, 20, 30, 40, 50, 60, 70]), (True, [1023] * 8)])
def test_plan_chunks_cover_each_visible_row_once(batched, positions):
    n = len(positions) if batched else 4
    H = 12
    blocks = plan_stack(n, 768, 4, H, W, positions, N_SM, 4, batched=batched)
    seen = {}
    for e in blocks:
        for g, h, r0, rows in e["chunks"]:
            assert 0 <= rows <= 32 and r0 % 32 == 0
            seen.setdefault((g, h), []).append((r0, rows))
    for g, pos in enumerate(positions):
        length = min(max(pos, 0), W)
        for h in range(H):
            got = seen.pop((g, h))
            rows = [r for r0, k in got for r in range(r0, r0 + k)]
            assert rows == list(range(length))          # once each, in order
            assert len(got) == max(1, -(-length // 32))
    assert not seen


@pytest.mark.parametrize("wbytes", [1, 2, 4])
@pytest.mark.parametrize("n,d,positions", [
    (1, 768, [512]), (8, 768, [0, 5, 37, 100, 511, 1000, 1023, 17]),
    (4, 1600, [37]), (2, 64, [3, 60])])
def test_plan_shares_differ_by_at_most_one_tile(n, d, positions, wbytes):
    """Each product's share differs by at most one 16-byte column vector (a
    tile of K rows x 16 bytes) across the blocks; the attention chunks by at
    most one chunk."""
    batched = len(positions) > 1
    blocks = plan_stack(n, d, 4, d // 64, W, positions, N_SM, wbytes,
                        batched=batched)
    ve = 16 // wbytes
    for key in ("qkv", "proj", "fc"):
        cols = [e[key][1] - e[key][0] for e in blocks]
        assert max(cols) - min(cols) <= ve
    chunks = [len(e["chunks"]) for e in blocks]
    assert max(chunks) - min(chunks) <= 1
    # the weight bytes a block streams a layer: at most a tile of each
    # product (qkv, proj, fc and its fc2 rows) above the least
    wb = [e["bytes"] - sum(2 * k * 64 * wbytes for *_, k in e["chunks"])
          for e in blocks]
    assert max(wb) - min(wb) <= 16 * d * 3 + ve * d * wbytes


@pytest.mark.parametrize("wbytes", [1, 2, 4])
@pytest.mark.parametrize("d", [64, 128, 768, 1024, 1280, 1600, 2048, 4096])
def test_stack_smem_fits_every_supported_shape(d, wbytes):
    """The ring keeps at least two slots (32 KB where four fit, else 16 KB)
    inside 227 KB at every width and row count the kernel admits (GPT-2
    small to XL and d 4096), and a block's column quads of a product fit
    its 256 threads."""
    for n in range(1, 9):
        assert stack_supported(d=d, hd=64, n=n)
        nbytes, slot, slots = stack_smem(n, d, 4, N_SM, wbytes)
        assert slot in (16384, 32768) and 2 <= slots <= 12
        assert slot * slots <= 196608 and (slot == 16384 or slots >= 4)
        assert nbytes <= 232448 - 2048
        assert nbytes == slots * slot + n * d * 4 + 256 * 8 * 16 + 8192 + (
            (n * -(-(4 * d * wbytes // 16) // N_SM) * (16 // wbytes) * 4
             + 15) & ~15)
    ve = 16 // wbytes
    for ncols in (3 * d, 4 * d):
        assert -(-(ncols // ve) // N_SM) * ve // 4 <= 256


def _softmax_attention(q, k, v, scale):
    s = (k @ q) * scale
    p = np.exp(s - s.max())
    return (p / p.sum()) @ v


@pytest.mark.parametrize("batched,positions", [
    (False, [0]), (False, [77]), (False, [1000]),
    (True, [0, 5, 37, 100, 511, 1000, 1023, 17]), (True, [W, 1, 64])])
def test_chunked_attention_merged_as_the_kernel_merges(batched, positions):
    """The kernel's attention arithmetic on the plan, in float64: each
    block folds its consecutive chunks of a (group, head) pair into one
    online-softmax partial (m, l, context), and the pair's merge takes the
    partials in block order plus the in-flight rows (extend: rows j <= r;
    batched: the row's own) -- against plain softmax attention over the
    visible cache rows and the in-flight rows."""
    rng = np.random.default_rng(len(positions) + positions[0])
    n = len(positions) if batched else 4
    H, hd, scale = 3, 64, 0.125
    groups = len(positions)
    kc = rng.standard_normal((groups, H, W, hd))
    vc = rng.standard_normal((groups, H, W, hd))
    q = rng.standard_normal((n, H, hd))
    kn = rng.standard_normal((n, H, hd))
    vn = rng.standard_normal((n, H, hd))
    rows = 1 if batched else n
    blocks = plan_stack(n, H * hd, 4, H, W, positions, N_SM, 4,
                        batched=batched)
    partials = {}  # (g, h) -> [(m, l, acc (rows, hd))] in block order
    for e in blocks:
        state = None
        for ci, (g, h, r0, k) in enumerate(e["chunks"]):
            if state is None or state[0] != (g, h):
                state = [(g, h), np.full(rows, -1e30), np.zeros(rows),
                         np.zeros((rows, hd))]
            _, m, l, acc = state
            for i in range(rows):
                r = g if batched else i
                s = kc[g, h, r0:r0 + k] @ q[r, h] * scale
                mn = max(m[i], s.max(initial=-1e30))
                p = np.exp(s - mn)
                corr = np.exp(m[i] - mn)
                l[i] = l[i] * corr + p.sum()
                acc[i] = acc[i] * corr + p @ vc[g, h, r0:r0 + k]
                m[i] = mn
            nxt = e["chunks"][ci + 1] if ci + 1 < len(e["chunks"]) else None
            if nxt is None or nxt[:2] != (g, h):
                partials.setdefault((g, h), []).append((m, l, acc))
    for g, pos in enumerate(positions):
        length = min(pos, W)
        for h in range(H):
            parts = partials[(g, h)]
            for i in range(rows):
                r = g if batched else i
                own = [r] if batched else list(range(r + 1))
                ss = [kn[j, h] @ q[r, h] * scale for j in own]
                M = max([p[0][i] for p in parts] + ss)
                L_ = sum(p[1][i] * np.exp(p[0][i] - M) for p in parts)
                A = sum(p[2][i] * np.exp(p[0][i] - M) for p in parts)
                for j, sj in zip(own, ss):
                    L_ += np.exp(sj - M)
                    A = A + np.exp(sj - M) * vn[j, h]
                want = _softmax_attention(
                    q[r, h], np.concatenate([kc[g, h, :length], kn[own, h]]),
                    np.concatenate([vc[g, h, :length], vn[own, h]]), scale)
                np.testing.assert_allclose(A / L_, want, rtol=1e-12,
                                           atol=1e-12)
