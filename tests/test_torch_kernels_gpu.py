"""The port's Hopper kernels against their plain PyTorch versions, on the
card. Every test here is marked ``gpu`` and skips without a Hopper card
(the ``sm_90a`` kernels have no CPU mode). The file imports nothing of
JAX, so it runs on a machine with the card and without JAX::

    MMLSPARK_TPU_TEST_TPU=1 python -m pytest tests/test_torch_kernels_gpu.py

(``MMLSPARK_TPU_TEST_TPU=1`` keeps ``tests/conftest.py`` from setting up
the JAX CPU mesh). ``chip_smoke.py`` repeats these checks at the
slice's full width and times them.
"""

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.core.environment import cuda_sm90_available
from mmlspark_tpu_torch.gbdt import Booster, BoosterParams
from mmlspark_tpu_torch.gbdt import cuda_hist as CH
from mmlspark_tpu_torch.ops import fused_ce as FC
from mmlspark_tpu_torch.parallel import cuda_attention as CA
from mmlspark_tpu_torch.parallel import ring_attention as RA
from mmlspark_tpu_torch.parallel import topology as TP

pytestmark = pytest.mark.gpu

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture
def dev():
    if not cuda_sm90_available():
        pytest.skip("needs a Hopper CUDA card (the sm_90a kernels have no "
                    "CPU mode)")
    return torch.device("cuda")


def _rnd(gen, dev, *shape):
    return torch.randn(*shape, generator=gen).to(dev)


def _launch_and_compare(name, wrapper, plain, args, launches=CA.LAUNCHES):
    before = launches[name]
    got = wrapper(*args)
    torch.cuda.synchronize()
    assert launches[name] == before + 1
    want = plain(*args)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)


# head dims 8 (tests), 16 and 64 (the slice); positions at 0, page edges
# and the lane end
@pytest.mark.parametrize("d,ps,pps,pos", [
    (8, 8, 4, [0, 17, 31]), (16, 16, 4, [63, 5, 16]),
    (64, 16, 64, [0, 1, 15, 16, 300, 511, 1000, 1023])])
def test_paged_decode_matches_plain(dev, d, ps, pps, pos):
    gen = torch.Generator().manual_seed(d)
    n, h = len(pos), 2
    n_pages = 1 + n * pps
    tables = (1 + torch.randperm(n * pps, generator=gen)).reshape(
        n, pps).to(torch.int32).to(dev)
    args = (_rnd(gen, dev, n, h, d), _rnd(gen, dev, n_pages, ps, h, d),
            _rnd(gen, dev, n_pages, ps, h, d), tables,
            torch.tensor(pos, dtype=torch.int32, device=dev), d ** -0.5, ps)
    _launch_and_compare("paged_decode_attention", CA.paged_decode_attention,
                        CA.paged_decode_attention_plain, args)


# S at and around the 32-row tiles (15, 16, 63-65, 129), the prompt bucket
# (512), the decoder's max_len (1024) and one past any tile (1000); Dh 9 and
# 20 are padded in shared memory (9: rows not 16-byte aligned)
@pytest.mark.parametrize("b,s,h,d", [(2, 1, 3, 8), (2, 63, 3, 8),
                                     (1, 100, 2, 16), (1, 257, 8, 64),
                                     (1, 15, 2, 64), (1, 16, 3, 64),
                                     (2, 65, 2, 16), (1, 129, 2, 9),
                                     (1, 512, 8, 64), (1, 1000, 2, 20),
                                     (1, 1024, 8, 64)])
def test_flash_prefill_matches_plain(dev, b, s, h, d):
    gen = torch.Generator().manual_seed(s)
    args = tuple(_rnd(gen, dev, b, s, h, d) for _ in range(3))
    _launch_and_compare("flash_prefill_attention",
                        CA.flash_prefill_attention,
                        CA.flash_prefill_attention_plain, args)


def test_flash_prefill_takes_unaligned_rows(dev):
    """f32 tensors whose storage starts 4 bytes past an allocation (rows
    not 16-byte aligned): K and V are staged by element copies."""
    gen = torch.Generator().manual_seed(5)
    shape = (1, 70, 2, 64)
    n = int(np.prod(shape))

    def shifted():
        return torch.randn(n + 1, generator=gen).to(dev)[1:].view(shape)

    args = tuple(shifted() for _ in range(3))
    assert args[1].data_ptr() % 16
    _launch_and_compare("flash_prefill_attention",
                        CA.flash_prefill_attention,
                        CA.flash_prefill_attention_plain, args)


@pytest.mark.parametrize("s", [129, 512])
def test_flash_prefill_repeats_bitwise(dev, s):
    gen = torch.Generator().manual_seed(s + 1)
    args = tuple(_rnd(gen, dev, 1, s, 8, 64) for _ in range(3))
    first = CA.flash_prefill_attention(*args)
    second = CA.flash_prefill_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# (7, 32, 32) pads past the 7-page lane: the kernel must mask at its end
@pytest.mark.parametrize("pps,hit,s,d", [(4, 8, 16, 8), (7, 32, 32, 8),
                                         (64, 256, 16, 64),
                                         (64, 1008, 64, 64)])
def test_paged_prefix_matches_plain(dev, pps, hit, s, d):
    gen = torch.Generator().manual_seed(hit)
    ps, h = (8 if d == 8 else 16), 2
    table = (1 + torch.randperm(pps, generator=gen)).to(torch.int32).to(dev)
    args = (_rnd(gen, dev, s, h, d), _rnd(gen, dev, 1 + pps, ps, h, d),
            _rnd(gen, dev, 1 + pps, ps, h, d), table, hit, d ** -0.5, ps)
    _launch_and_compare("paged_prefix_prefill_attention",
                        CA.paged_prefix_prefill_attention,
                        CA.paged_prefix_prefill_attention_plain, args)


# (256, 24) is not a multiple of 16; (256, 768) and (16, 1008) are long
# suffixes (one key split), (256, 16), (256, 24) and (256, 100) short ones
# whose keys split across blocks; Dh 36 pads to 64 in shared memory
@pytest.mark.parametrize("hit,s,d", [(256, 768, 64), (16, 1008, 64),
                                     (256, 24, 64), (256, 100, 36),
                                     (0, 1, 64), (1000, 24, 64)])
def test_paged_prefix_at_the_plan_shapes(dev, hit, s, d):
    gen = torch.Generator().manual_seed(hit + s)
    ps, pps, h = 16, 64, 8
    table = (1 + torch.randperm(pps, generator=gen)).to(torch.int32).to(dev)
    args = (_rnd(gen, dev, s, h, d), _rnd(gen, dev, 1 + pps, ps, h, d),
            _rnd(gen, dev, 1 + pps, ps, h, d), table, hit, d ** -0.5, ps)
    _launch_and_compare("paged_prefix_prefill_attention",
                        CA.paged_prefix_prefill_attention,
                        CA.paged_prefix_prefill_attention_plain, args)


# K1's split plan: the decode path's width (one page a split), a batch whose
# plan runs 8 pages a split, pages streamed in chunks of 8 rows (64-row
# pages at 8 x 64), and the tests' small width
K1_PLAN_SHAPES = [(8, 8, 64, 16, 64), (64, 2, 16, 8, 64), (4, 8, 64, 64, 8),
                  (3, 2, 8, 8, 4)]


def _k1_inputs(gen, dev, n, h, d, ps, pps, pos, free=()):
    """A pool with a scratch page 0 and each slot's own pages; slots in
    ``free`` ride at pos 0 on an all-scratch table, as the decoder's free
    slots do."""
    n_pages = 1 + n * pps
    tables = (1 + torch.randperm(n * pps, generator=gen)).reshape(n, pps)
    pos = list(pos)
    for i in free:
        tables[i] = 0
        pos[i] = 0
    return (_rnd(gen, dev, n, h, d), _rnd(gen, dev, n_pages, ps, h, d),
            _rnd(gen, dev, n_pages, ps, h, d),
            tables.to(torch.int32).to(dev),
            torch.tensor(pos, dtype=torch.int32, device=dev), d ** -0.5, ps)


def _plan_positions(n, pps, ps):
    """Every split boundary of K1's plan (a split's first row and the row
    before it), pos 0 and the lane's last row."""
    per, n_splits = CA.paged_decode_plan(n, pps)
    edges = {0, pps * ps - 1}
    for j in range(1, n_splits):
        edges |= {j * per * ps - 1, j * per * ps}
    return sorted(edges)


@pytest.mark.parametrize("n,h,d,ps,pps", K1_PLAN_SHAPES)
def test_paged_decode_at_every_split_boundary(dev, n, h, d, ps, pps):
    gen = torch.Generator().manual_seed(n * pps + d)
    edges = _plan_positions(n, pps, ps)
    for i in range(0, len(edges), n):
        pos = (edges[i:i + n] + [0] * n)[:n]
        _launch_and_compare("paged_decode_attention",
                            CA.paged_decode_attention,
                            CA.paged_decode_attention_plain,
                            _k1_inputs(gen, dev, n, h, d, ps, pps, pos))
    # free slots among live ones
    pos = [edges[len(edges) // 2]] * n
    _launch_and_compare("paged_decode_attention", CA.paged_decode_attention,
                        CA.paged_decode_attention_plain,
                        _k1_inputs(gen, dev, n, h, d, ps, pps, pos,
                                   free=range(0, n, 2)))


def _poison(pool, live, last_rows):
    """A copy of ``pool`` with NaN in every page outside ``live`` (scratch
    page 0 among them) and +-1e30 in each live last page's rows past the
    lane's last row (``last_rows``: page -> last live row)."""
    dirty = pool.clone()
    dead = torch.ones(pool.shape[0], dtype=torch.bool)
    dead[list(live)] = False
    dirty[dead.to(pool.device)] = float("nan")
    for page, last in last_rows.items():
        tail = dirty[page, last + 1:]
        sign = torch.ones(tail.numel(), device=pool.device)
        sign[1::2] = -1
        tail.copy_((1e30 * sign).view(tail.shape))
    return dirty


def test_paged_decode_never_reads_dead_pages(dev):
    """Unclaimed table entries aim at scratch page 0, as the scheduler
    leaves them: NaN in every page past a lane's live end and in page 0,
    +-1e30 in the rows past pos of each live last page, and the output is
    the clean pool's bit for bit."""
    gen = torch.Generator().manual_seed(11)
    n, h, d, ps, pps = 8, 8, 64, 16, 64
    pos = [0, 5, 16, 300, 511, 1000, 1023, 17]
    q, kp, vp, tables, pos_t, scale, _ = _k1_inputs(gen, dev, n, h, d, ps,
                                                    pps, pos)
    live, last_rows = set(), {}
    for i, p in enumerate(pos):
        tables[i, p // ps + 1:] = 0
        pages = tables[i, :p // ps + 1].tolist()
        live |= set(pages)
        last_rows[pages[-1]] = p % ps
    clean = CA.paged_decode_attention(q, kp, vp, tables, pos_t, scale, ps)
    dirty = CA.paged_decode_attention(q, _poison(kp, live, last_rows),
                                      _poison(vp, live, last_rows), tables,
                                      pos_t, scale, ps)
    torch.cuda.synchronize()
    assert torch.isfinite(clean).all()
    assert torch.equal(clean, dirty)


@pytest.mark.parametrize("hit,s", [(256, 24), (256, 100), (0, 40)])
def test_paged_prefix_never_reads_dead_pages(dev, hit, s):
    gen = torch.Generator().manual_seed(hit + s)
    h, d, ps, pps = 8, 64, 16, 64
    kv_end = min(pps * ps, hit + s)
    n_live = -(-kv_end // ps)
    table = torch.zeros(pps, dtype=torch.int32)
    table[:n_live] = 1 + torch.randperm(pps, generator=gen)[:n_live]
    table = table.to(dev)
    q = _rnd(gen, dev, s, h, d)
    kp, vp = (_rnd(gen, dev, 1 + pps, ps, h, d) for _ in range(2))
    live = set(table[:n_live].tolist())
    last_rows = {int(table[n_live - 1]): (kv_end - 1) % ps}
    clean = CA.paged_prefix_prefill_attention(q, kp, vp, table, hit,
                                              d ** -0.5, ps)
    dirty = CA.paged_prefix_prefill_attention(
        q, _poison(kp, live, last_rows), _poison(vp, live, last_rows),
        table, hit, d ** -0.5, ps)
    torch.cuda.synchronize()
    assert torch.isfinite(clean).all()
    assert torch.equal(clean, dirty)


def test_paged_decode_repeats_bitwise(dev):
    gen = torch.Generator().manual_seed(3)
    n, h, d, ps, pps = K1_PLAN_SHAPES[0]
    edges = _plan_positions(n, pps, ps)
    args = _k1_inputs(gen, dev, n, h, d, ps, pps,
                      edges[1::len(edges) // n][:n])
    first = CA.paged_decode_attention(*args)
    second = CA.paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("hit,s", [(256, 16), (256, 768)])
def test_paged_prefix_repeats_bitwise(dev, hit, s):
    gen = torch.Generator().manual_seed(s)
    h, d, ps, pps = 8, 64, 16, 64
    table = (1 + torch.randperm(pps, generator=gen)).to(torch.int32).to(dev)
    args = (_rnd(gen, dev, s, h, d), _rnd(gen, dev, 1 + pps, ps, h, d),
            _rnd(gen, dev, 1 + pps, ps, h, d), table, hit, d ** -0.5, ps)
    first = CA.paged_prefix_prefill_attention(*args)
    second = CA.paged_prefix_prefill_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def _unaligned(gen, dev, *shape):
    """f32 storage that starts 4 bytes past an allocation: rows are not
    16-byte aligned."""
    n = int(np.prod(shape))
    x = torch.randn(n + 1, generator=gen).to(dev)[1:].view(shape)
    assert x.data_ptr() % 16
    return x


# Dh 64 on a shifted pool, and Dh 9 with H 3 (27 floats a row: no row of
# any pool is 16-byte aligned)
@pytest.mark.parametrize("h,d", [(8, 64), (3, 9)])
def test_paged_kernels_take_unaligned_pools(dev, h, d):
    gen = torch.Generator().manual_seed(d)
    n, ps, pps = 4, 16, 8
    args = list(_k1_inputs(gen, dev, n, h, d, ps, pps, [0, 17, 100, 127]))
    args[1] = _unaligned(gen, dev, *args[1].shape)
    args[2] = _unaligned(gen, dev, *args[2].shape)
    _launch_and_compare("paged_decode_attention", CA.paged_decode_attention,
                        CA.paged_decode_attention_plain, tuple(args))
    table = args[3][1].contiguous()
    for hit, s in [(32, 16), (16, 70)]:
        pargs = (_rnd(gen, dev, s, h, d), args[1], args[2], table, hit,
                 d ** -0.5, ps)
        _launch_and_compare("paged_prefix_prefill_attention",
                            CA.paged_prefix_prefill_attention,
                            CA.paged_prefix_prefill_attention_plain, pargs)


def test_head_dim_past_the_kernels_refused(dev):
    q = torch.zeros(1, 4, 2, CA.MAX_HEAD_DIM + 8, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        CA.flash_prefill_attention(q, q, q)


# K4: T from one token to past one token tile, V aligned and not to the
# kernel's 128-column slices, D past and below its 32-deep chunks; label
# -1 and label V match no column (gold 0)
@pytest.mark.parametrize("t,d,v", [(1, 16, 129), (7, 64, 300),
                                   (24, 512, 32768), (100, 512, 32000),
                                   (33, 40, 1000)])
def test_fused_softmax_xent_matches_plain(dev, t, d, v):
    gen = torch.Generator().manual_seed(t + v)
    h = _rnd(gen, dev, t, d)
    w = 0.02 * _rnd(gen, dev, d, v)
    labels = torch.randint(0, v, (t,), generator=gen, dtype=torch.int32)
    labels[0] = -1
    labels[-1] = v
    _launch_and_compare("fused_softmax_xent", FC.fused_softmax_xent,
                        FC.fused_softmax_xent_plain,
                        (h, w, labels.to(dev)), launches=FC.LAUNCHES)


# ---------------------------------------------------------------------------
# the train step's kernels: attention forward with lse, dq, dk/dv (K7, K5),
# K4's training variant, K6 dh and dW; f32 and bf16 inputs. bf16 differs
# from the plain version where the kernel rounds p relative to a running
# max (over K7's and K8's 64-key tiles) and the plain one relative to the
# row's max, and in the order of the f32 sums before each rounding:
# limits stated per case.

BF16_ATTN = dict(atol=2e-2, rtol=2e-2)
BF16_CE = dict(atol=2e-2, rtol=2e-2)


def _tol(dtype):
    return TOL if dtype == torch.float32 else BF16_ATTN


def _attn_inputs(gen, dev, b, sq, sk, h, d, dtype):
    q = _rnd(gen, dev, b, sq, h, d).to(dtype)
    k = _rnd(gen, dev, b, sk, h, d).to(dtype)
    v = _rnd(gen, dev, b, sk, h, d).to(dtype)
    do = _rnd(gen, dev, b, sq, h, d).to(dtype)
    return q, k, v, do


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)


#: scaled-error limits, as ``chip_smoke.py`` holds the kernels: the max
#: over elements of |got - want| / (|want| + RMS(want)), the RMS at least
#: 1e-3 (dq and dk are zero in exact arithmetic at Sq = 1). Each element
#: is held to its own magnitude plus the output's typical one, so a zero
#: or wrong output fails however small the values are.
SCALED_F32, SCALED_BF16 = 1e-3, 4e-2


def _scaled(dtype):
    return SCALED_F32 if dtype == torch.float32 else SCALED_BF16


def _close_scaled(got, want, limit, name=""):
    got, want = got.float().cpu(), want.float().cpu()
    rms = max(float(want.square().mean().sqrt()), 1e-3)
    scaled = float(((got - want).abs() / (want.abs() + rms)).max())
    assert scaled <= limit, f"{name}: scaled error {scaled:.3e} > {limit}"


# one row, unaligned S, cross-attention Sq != Sk both ways, Dh 16 and 64;
# then the edges of the bf16 kernels' 64-row tiles (S 63, 64, 65, 127,
# 129; Sq and Sk on either side of a tile boundary), causal and not, and
# head dims that are no multiple of 8 (the bf16 kernels stage those rows
# through element loads instead of 16-byte copies)
ATTN_SHAPES = [(1, 1, 1, 2, 16, True), (2, 17, 17, 3, 16, True),
               (2, 128, 128, 8, 64, True), (1, 100, 100, 2, 64, False),
               (1, 48, 80, 2, 64, True), (1, 80, 48, 2, 16, True),
               (1, 63, 63, 2, 64, True), (2, 64, 64, 2, 16, False),
               (1, 65, 65, 3, 64, True), (1, 127, 127, 2, 16, True),
               (1, 129, 129, 2, 64, False), (1, 60, 70, 2, 64, True),
               (1, 130, 63, 2, 16, True), (1, 65, 129, 2, 64, False),
               (1, 70, 70, 2, 20, True), (1, 100, 100, 3, 63, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,d,causal", ATTN_SHAPES)
def test_attention_train_kernels_match_plain(dev, b, sq, sk, h, d, causal,
                                             dtype):
    gen = torch.Generator().manual_seed(sq * 7 + sk)
    q, k, v, do = _attn_inputs(gen, dev, b, sq, sk, h, d, dtype)
    scale = d ** -0.5
    before = dict(CA.LAUNCHES)
    out, lse = CA.attention_fwd(q, k, v, causal, out_dtype=torch.float32)
    torch.cuda.synchronize()
    want_out, want_lse = CA.attention_fwd_plain(q, k, v, causal, scale)
    _close(out, want_out, **_tol(dtype))
    _close_scaled(out, want_out, _scaled(dtype), "out")
    _close(lse, want_lse, **TOL)
    delta = (do.float() * out).sum(-1).transpose(1, 2).contiguous()
    got = CA.attention_bwd(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    want = CA.attention_bwd_plain(q, k, v, do, lse, delta, causal, scale)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32, name
        _close(g, w, err_msg=name, **_tol(dtype))
        _close_scaled(g, w, _scaled(dtype), name)
    for name in ("attention_fwd", "attention_bwd_dq", "attention_bwd_dkdv"):
        assert CA.LAUNCHES[name] == before[name] + 1


def _bwd_on(q, k, v, do, causal):
    """The forward's lse and the backward's delta, then the kernels'
    (dq, dk, dv) and the plain version's on the same inputs."""
    scale = q.shape[-1] ** -0.5
    out, lse = CA.attention_fwd(q, k, v, causal, out_dtype=torch.float32)
    delta = (do.float() * out).sum(-1).transpose(1, 2).contiguous()
    got = CA.attention_bwd(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    return out, lse, got, CA.attention_bwd_plain(q, k, v, do, lse, delta,
                                                 causal, scale)


def test_attention_train_kernels_at_the_bench_shape(dev):
    """The train step's shape in bf16 (B 8, S 1024, 8 heads x 64, causal):
    16 query and key tiles a head, the causal loop bounds and the
    longest-first block order at full size, held to the scaled limit."""
    gen = torch.Generator().manual_seed(8)
    q, k, v, do = _attn_inputs(gen, dev, 8, 1024, 1024, 8, 64,
                               torch.bfloat16)
    out, lse, got, want = _bwd_on(q, k, v, do, True)
    want_out, want_lse = CA.attention_fwd_plain(q, k, v, True, 64 ** -0.5)
    _close_scaled(out, want_out, SCALED_BF16, "out")
    _close(lse, want_lse, **TOL)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        _close_scaled(g, w, SCALED_BF16, name)


def test_attention_train_kernels_take_unaligned_rows(dev):
    """bf16 tensors whose storage starts 2 bytes past an allocation (rows
    not 16-byte aligned): the kernels stage through element loads and
    agree with the plain version as the aligned ones do."""
    gen = torch.Generator().manual_seed(9)
    shape = (1, 80, 2, 64)
    n = int(np.prod(shape))

    def shifted():
        flat = torch.randn(n + 1, generator=gen).to(torch.bfloat16).to(dev)
        return flat[1:].view(shape)

    q, k, v, do = (shifted() for _ in range(4))
    assert q.data_ptr() % 16
    before = dict(CA.LAUNCHES)
    out, lse, got, want = _bwd_on(q, k, v, do, True)
    want_out, _ = CA.attention_fwd_plain(q, k, v, True, 64 ** -0.5)
    _close_scaled(out, want_out, SCALED_BF16, "out")
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        _close_scaled(g, w, SCALED_BF16, name)
    for name in ("attention_fwd", "attention_bwd_dq", "attention_bwd_dkdv"):
        assert CA.LAUNCHES[name] == before[name] + 1


@pytest.mark.parametrize("fn", [
    CA.flash_attention_folded, CA.flash_attention,
    lambda q, k, v, c: CA.flash_attention(q, k, v, c, bwd_impl="pallas")],
    ids=["folded", "flash", "flash_pallas"])
def test_differentiable_attention_runs_the_kernels(dev, fn):
    """Each autograd Function on the card (K7; K5 under either JAX
    ``bwd_impl``): one forward, one dq and one dk/dv launch, grads in the
    input dtype."""
    gen = torch.Generator().manual_seed(1)
    q, k, v, do = _attn_inputs(gen, dev, 2, 256, 256, 2, 64,
                               torch.bfloat16)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    before = dict(CA.LAUNCHES)
    out = fn(q, k, v, True)
    out.backward(do)
    torch.cuda.synchronize()
    assert out.dtype == q.grad.dtype == torch.bfloat16
    for name in ("attention_fwd", "attention_bwd_dq", "attention_bwd_dkdv"):
        assert CA.LAUNCHES[name] == before[name] + 1


def _ce_inputs(gen, dev, t, d, v, dtype):
    """Labels -1 and V (no column matches) at the ends; g zero on every
    third token (those rows of dh must come out 0)."""
    h = _rnd(gen, dev, t, d).to(dtype)
    w = (0.02 * _rnd(gen, dev, d, v)).to(dtype)
    labels = torch.randint(0, v, (t,), generator=gen, dtype=torch.int32)
    labels[0] = -1
    labels[-1] = v
    g = torch.rand(t, generator=gen)
    g[1::3] = 0.0
    return h, w, labels.to(dev), g.to(dev)


# the bf16 kernels' tile edges: T around their 64- and 128-token tiles, V
# around the 64-column chunks and 128-column slices (129 and 300: W and
# logits rows not 16-byte aligned, staged by element loads), D of one
# 16-deep k-slice, not a multiple of 8 (36: h rows not 16-byte aligned),
# inside and past one 64-deep chunk, and the bench width; each (T, V)
# pair with one D, rotated from one T to the next
CE_EDGE_SHAPES = [
    (t, (16, 36, 40, 72, 512)[(i + i // 5 + 1) % 5], v) for i, (t, v) in
    enumerate((t, v) for t in (1, 63, 64, 65, 129, 513)
              for v in (129, 300, 1000, 32000, 32768))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d,v", [(1, 16, 129), (7, 64, 300),
                                   (130, 40, 1000), (512, 512, 32000)]
                         + CE_EDGE_SHAPES)
def test_fused_ce_train_kernels_match_plain(dev, t, d, v, dtype):
    gen = torch.Generator().manual_seed(t + v)
    h, w, labels, g = _ce_inputs(gen, dev, t, d, v, dtype)
    before = dict(FC.LAUNCHES)
    ce, logits, lse = FC._forward(h, w, labels, store=True)
    torch.cuda.synchronize()
    want_ce, want_logits, want_lse = FC._forward_plain(h, w, labels)
    _close(ce, want_ce, **TOL)
    _close(lse, want_lse, **TOL)
    tol = TOL if dtype == torch.float32 else BF16_CE
    _close(logits, want_logits.to(dtype), **tol)
    _close_scaled(logits, want_logits.to(dtype), _scaled(dtype), "logits")
    dh = FC.fused_ce_dh(h, w, labels, g, logits, lse)
    dw = FC.fused_ce_dw(h, w, labels, g, logits, lse)
    torch.cuda.synchronize()
    assert dh.dtype == dw.dtype == dtype
    for got, plain, name in ((dh, FC.fused_ce_dh_plain, "dh"),
                             (dw, FC.fused_ce_dw_plain, "dw")):
        want = plain(h, w, labels, g, logits, lse)
        _close(got, want, err_msg=name, **tol)
        _close_scaled(got, want, _scaled(dtype), name)
    for name in ("fused_softmax_xent_train", "fused_ce_dh", "fused_ce_dw"):
        assert FC.LAUNCHES[name] == before[name] + 1
    assert FC.LAUNCHES["fused_softmax_xent"] == before["fused_softmax_xent"]


def test_fused_ce_train_kernels_at_the_bench_shape(dev):
    """The train step's loss in bf16 (T 8192, D 512, V 32768): 64 token
    tiles x 256 vocab slices forward, the full 512-chunk V loop of dh and
    the 128-chunk T loop of dW, held to the scaled limit."""
    gen = torch.Generator().manual_seed(8192)
    h, w, labels, g = _ce_inputs(gen, dev, 8192, 512, 32768, torch.bfloat16)
    ce, logits, lse = FC._forward(h, w, labels, store=True)
    torch.cuda.synchronize()
    want_ce, want_logits, want_lse = FC._forward_plain(h, w, labels)
    _close(ce, want_ce, **TOL)
    _close(lse, want_lse, **TOL)
    _close_scaled(logits, want_logits.to(torch.bfloat16), SCALED_BF16,
                  "logits")
    del want_logits
    args = (h, w, labels, g, logits, lse)
    for got, plain, name in ((FC.fused_ce_dh(*args), FC.fused_ce_dh_plain,
                              "dh"),
                             (FC.fused_ce_dw(*args), FC.fused_ce_dw_plain,
                              "dw")):
        _close_scaled(got, plain(*args), SCALED_BF16, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_ce_backward_repeats_bitwise(dev, dtype):
    """Each output element's whole sum stays in one block (no atomics, no
    split-K): two launches of dh, and of dW, on the same inputs are
    bitwise equal."""
    gen = torch.Generator().manual_seed(3)
    h, w, labels, g = _ce_inputs(gen, dev, 513, 512, 32000, dtype)
    _, logits, lse = FC._forward(h, w, labels, store=True)
    args = (h, w, labels, g, logits, lse)
    for fn in (FC.fused_ce_dh, FC.fused_ce_dw):
        first, second = fn(*args), fn(*args)
        torch.cuda.synchronize()
        assert torch.equal(first, second), fn.__name__


# the f32 forward's two kernels: T up to 64 streams W once (the verify's
# kernel, h whole in shared memory), past 64 the (128, 128)-tile kernel;
# V a multiple of 128, of 4 only (32000) and odd (W's rows not 16-byte
# aligned: element loads); D 510 (h's rows not 16-byte aligned)
@pytest.mark.parametrize("d", [512, 510])
@pytest.mark.parametrize("v", [32768, 32000, 1001])
@pytest.mark.parametrize("t", [1, 7, 24, 64, 65, 100, 2048])
def test_fused_softmax_xent_f32_in_both_regimes(dev, t, v, d):
    gen = torch.Generator().manual_seed(t * 7 + v + d)
    h, w, labels, _ = _ce_inputs(gen, dev, t, d, v, torch.float32)
    _launch_and_compare("fused_softmax_xent", FC.fused_softmax_xent,
                        FC.fused_softmax_xent_plain, (h, w, labels),
                        launches=FC.LAUNCHES)


@pytest.mark.parametrize("t", [24, 2048])
@pytest.mark.parametrize("store", [False, True])
def test_fused_softmax_xent_f32_repeats_bitwise(dev, t, store):
    """Both f32 forward kernels, with and without the logits store, sum in
    a fixed order (no atomics): two launches give the same bits."""
    gen = torch.Generator().manual_seed(t)
    h, w, labels, _ = _ce_inputs(gen, dev, t, 512, 32768, torch.float32)
    first = FC._forward(h, w, labels, store=store)
    second = FC._forward(h, w, labels, store=store)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("t", [2048, 777])
def test_fused_ce_f32_train_kernels_at_the_parity_shape(dev, t):
    """K4's f32 training variant and K6's f32 dh and dW (3xTF32) at the f32
    train parity step's T (2048: dh's 128 blocks) and an odd T, D 512,
    V 32768, within the f32 limits."""
    gen = torch.Generator().manual_seed(t + 1)
    h, w, labels, g = _ce_inputs(gen, dev, t, 512, 32768, torch.float32)
    ce, logits, lse = FC._forward(h, w, labels, store=True)
    torch.cuda.synchronize()
    want_ce, want_logits, want_lse = FC._forward_plain(h, w, labels)
    _close(ce, want_ce, **TOL)
    _close(lse, want_lse, **TOL)
    _close(logits, want_logits, **TOL)
    del want_logits
    args = (h, w, labels, g, logits, lse)
    for fn, plain, name in ((FC.fused_ce_dh, FC.fused_ce_dh_plain, "dh"),
                            (FC.fused_ce_dw, FC.fused_ce_dw_plain, "dw")):
        got, want = fn(*args), plain(*args)
        torch.cuda.synchronize()
        _close(got, want, err_msg=name, **TOL)
        _close_scaled(got, want, SCALED_F32, name)


@pytest.mark.parametrize("t,d,v", [(1, 16, 129), (65, 40, 300),
                                   (129, 72, 1000), (513, 512, 32768)])
def test_fused_softmax_xent_bf16_matches_plain(dev, t, d, v):
    """The bf16 forward that stores nothing (the tensor-core kernel without
    the logits store) against the plain version; it counts as
    ``fused_softmax_xent``."""
    gen = torch.Generator().manual_seed(t * 3 + v)
    h, w, labels, _ = _ce_inputs(gen, dev, t, d, v, torch.bfloat16)
    before = dict(FC.LAUNCHES)
    ce, logits, lse = FC._forward(h, w, labels, store=False)
    torch.cuda.synchronize()
    assert logits is None and lse is None
    _close(ce, FC.fused_softmax_xent_plain(h, w, labels), **TOL)
    assert FC.LAUNCHES["fused_softmax_xent"] == \
        before["fused_softmax_xent"] + 1
    assert FC.LAUNCHES["fused_softmax_xent_train"] == \
        before["fused_softmax_xent_train"]


# ---------------------------------------------------------------------------
# K8, the ring-attention block step


def _ring_positions(dev, b, s, case):
    """Per-row positions of a ring block pair: keys one block earlier
    (full), the same block (diagonal), one block later (none) or with a
    padded tail."""
    ar = torch.arange(s, dtype=torch.int32)
    qo, ko = {"full": (s, 0), "diagonal": (0, 0), "none": (0, s),
              "padded": (0, 0)}[case]
    k_pos = (ar + ko).expand(b, -1).clone()
    if case == "padded":
        k_pos[:, s - s // 3:] = CA.PAD_POS
    return (ar + qo).expand(b, -1).contiguous().to(dev), k_pos.to(dev)


RING_SHAPES = [(2, 128, 8, 64), (1, 100, 2, 16), (3, 33, 2, 64)]


def _check_ring_block(q, k, v, do, q_pos, k_pos, causal):
    """K8's forward partials, dq and dk/dv against their plain versions on
    the same inputs, one launch each; a row that sees no key comes out
    exactly m = -1e30, l = 0, o = 0. Returns the plain version's empty
    rows ([B, H, Sq]) and the kernels' grads."""
    dtype, scale = q.dtype, q.shape[-1] ** -0.5
    before = dict(CA.LAUNCHES)
    o, m, l = CA.ring_block_fwd(q, k, v, q_pos, k_pos, causal)
    torch.cuda.synchronize()
    ro, rm, rl = CA.ring_block_fwd_plain(q, k, v, q_pos, k_pos, causal,
                                         scale)
    dead = rl == 0
    assert bool((l[dead] == 0).all() and (m[dead] == -1e30).all())
    assert bool((o.transpose(1, 2)[dead] == 0).all())
    _close(l, rl, **_tol(dtype))
    _close(torch.where(dead, 0.0, m), torch.where(dead, 0.0, rm), **TOL)
    _close_scaled(o, ro, _scaled(dtype), "o")
    l_safe = l.clamp(min=1e-30)
    lse = torch.where(l > 0, m + torch.log(l_safe), 1e30)
    out = o / l_safe.transpose(1, 2)[..., None]
    delta = (do.float() * out).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, q_pos, k_pos, causal)
    got = (CA.ring_block_bwd_dq(*args), *CA.ring_block_bwd_dkdv(*args))
    torch.cuda.synchronize()
    want = CA.ring_block_bwd_plain(*args, scale)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32, name
        _close(g, w, err_msg=name, **_tol(dtype))
        _close_scaled(g, w, _scaled(dtype), name)
    for name in ("ring_block_fwd", "ring_block_bwd_dq", "ring_block_bwd_dkdv"):
        assert CA.LAUNCHES[name] == before[name] + 1
    return dead, got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,causal", [
    ("diagonal", True), ("full", True), ("none", True), ("padded", True),
    ("padded", False)])
@pytest.mark.parametrize("b,s,h,d", RING_SHAPES)
def test_ring_block_kernels_match_plain(dev, b, s, h, d, case, causal,
                                        dtype):
    """K8's forward partials, dq and dk/dv against their plain versions;
    a row that sees no key comes out exactly empty."""
    gen = torch.Generator().manual_seed(s + len(case))
    q, k, v, do = _attn_inputs(gen, dev, b, s, s, h, d, dtype)
    q_pos, k_pos = _ring_positions(dev, b, s, case)
    dead, _ = _check_ring_block(q, k, v, do, q_pos, k_pos, causal)
    if case == "none":
        assert bool(dead.all())


def _any_positions(dev, b, sq, sk, case, seed):
    """Positions the ring never makes, which the kernels take all the
    same: ``shuffled`` (queries after the first half of the keys; each
    64-key tile's positions permuted, and in every other tile a fifth of
    the keys padded at scattered rows: full, partial and dead tiles with
    unsorted positions), ``permuted`` (both sides a seeded permutation,
    a fifth of the keys padded) and ``dead row`` (the last batch row's
    keys all after its queries: it sees no key)."""
    rng = np.random.default_rng(seed)
    q_pos = np.tile(np.arange(sq, dtype=np.int32) + sk // 2, (b, 1))
    k_pos = np.tile(np.arange(sk, dtype=np.int32), (b, 1))
    if case == "shuffled":
        for row in k_pos:
            for t0 in range(0, sk, 64):
                row[t0:t0 + 64] = rng.permutation(row[t0:t0 + 64])
                if (t0 // 64) % 2 == 0:
                    n = len(row[t0:t0 + 64])
                    row[t0 + rng.choice(n, n // 5, replace=False)] = \
                        CA.PAD_POS
    elif case == "permuted":
        q_pos = np.stack([rng.permutation(sq) for _ in range(b)])
        k_pos = np.stack([rng.permutation(sk) for _ in range(b)])
        k_pos[rng.random((b, sk)) < 0.2] = CA.PAD_POS
    else:
        q_pos[-1] = np.arange(sq)
        k_pos[-1] = np.arange(sk) + sq
    return (torch.tensor(q_pos, dtype=torch.int32, device=dev),
            torch.tensor(k_pos, dtype=torch.int32, device=dev))


# Sq != Sk both ways, tile edges, Dh 16 and 36 (rows not 16-byte
# aligned: element loads), the ring's Dh 64
ANY_SHAPES = [(2, 200, 96, 2, 64), (2, 96, 200, 2, 64), (1, 130, 130, 3, 16),
              (2, 100, 170, 2, 36), (2, 256, 256, 2, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,causal", [
    ("shuffled", True), ("shuffled", False), ("permuted", True),
    ("dead row", True)])
@pytest.mark.parametrize("b,sq,sk,h,d", ANY_SHAPES)
def test_ring_block_kernels_take_any_positions(dev, b, sq, sk, h, d, case,
                                               causal, dtype):
    """Unsorted positions, padded keys inside tiles and Sq != Sk: the bf16
    kernels' live-tile lists (dead, full and partial tiles from the
    positions) and the f32 kernels give the plain versions' results; a
    batch row that sees no key comes out exactly empty, grads included."""
    gen = torch.Generator().manual_seed(sq * 3 + sk + d)
    q, k, v, do = _attn_inputs(gen, dev, b, sq, sk, h, d, dtype)
    q_pos, k_pos = _any_positions(dev, b, sq, sk, case, sq + sk)
    dead, (dq, dk, dv) = _check_ring_block(q, k, v, do, q_pos, k_pos,
                                           causal)
    if case == "dead row":
        assert bool(dead[-1].all())
        assert b == 1 or not bool(dead[0].any())
        assert float(dq[-1].abs().max()) == 0.0
        assert float(dk[-1].abs().max()) == float(dv[-1].abs().max()) == 0.0


def test_ring_block_kernels_take_unaligned_rows(dev):
    """bf16 tensors whose storage starts 2 bytes past an allocation: the
    kernels stage through element loads and agree with the plain
    versions as the aligned ones do."""
    gen = torch.Generator().manual_seed(10)
    shape = (2, 150, 2, 64)
    n = int(np.prod(shape))

    def shifted():
        flat = torch.randn(n + 1, generator=gen).to(torch.bfloat16).to(dev)
        return flat[1:].view(shape)

    q, k, v, do = (shifted() for _ in range(4))
    assert q.data_ptr() % 16
    q_pos, k_pos = _any_positions(dev, 2, 150, 150, "shuffled", 3)
    _check_ring_block(q, k, v, do, q_pos, k_pos, True)


def test_ring_block_bf16_refuses_lists_past_their_bound(dev):
    """The bf16 kernels list at most 4096 tiles of the other side (keys
    for the forward and dq, queries for dk/dv): one more key, or query,
    and the launch is refused and the wrapper raises; nothing falls back
    to the f32 kernels or the plain version."""
    long_, short = 64 * 4096 + 1, 64
    x = torch.zeros(1, short, 1, 8, dtype=torch.bfloat16, device=dev)
    y = torch.zeros(1, long_, 1, 8, dtype=torch.bfloat16, device=dev)
    ps, pl = (torch.arange(n, dtype=torch.int32, device=dev)
              for n in (short, long_))
    stats = torch.zeros(1, 1, short, device=dev)
    before = dict(CA.LAUNCHES)
    with pytest.raises(RuntimeError, match="failed to launch"):
        CA.ring_block_fwd(x, y, y, ps, pl)
    with pytest.raises(RuntimeError, match="failed to launch"):
        CA.ring_block_bwd_dq(x, y, y, x, stats, stats, ps, pl)
    with pytest.raises(RuntimeError, match="failed to launch"):
        CA.ring_block_bwd_dkdv(y, x, x, y, torch.zeros(1, 1, long_,
                                                        device=dev),
                               torch.zeros(1, 1, long_, device=dev), pl, ps)
    assert CA.LAUNCHES == before


def test_folded_ring_launches_each_kernel_once_per_step(dev):
    """A hosted {"seq": 4} ring on the card: the ranks of a ring step
    share one launch of each K8 kernel, and the result is dense
    attention's."""
    gen = torch.Generator().manual_seed(5)
    q, k, v, do = _attn_inputs(gen, dev, 2, 256, 256, 2, 64, torch.float32)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    mesh = TP.build_mesh(TP.MeshSpec.from_dict({"seq": 4}))
    before = dict(CA.LAUNCHES)
    out = RA.ring_attention(q, k, v, mesh, block_impl="folded")
    out.backward(do)
    torch.cuda.synchronize()
    for name in ("ring_block_fwd", "ring_block_bwd_dq", "ring_block_bwd_dkdv"):
        assert CA.LAUNCHES[name] == before[name] + 4
    with torch.no_grad():
        _close(out.detach(), CA.dense_attention(q, k, v, True), **TOL)


def test_interpret_modes_and_wide_heads_raise_on_the_card(dev):
    x = torch.zeros(1, 8, 2, 16, device=dev)
    pos = torch.arange(8, device=dev)
    with pytest.raises(ValueError, match="interpret"):
        CA.flash_block_attn(x, x, x, 1.0, pos, pos, True, interpret=True)
    with pytest.raises(ValueError, match="interpret"):
        RA.ring_attention(x, x, x, TP.build_mesh(TP.MeshSpec.from_dict(
            {"seq": 2})), block_impl="folded_interpret")
    wide = torch.zeros(1, 8, 2, CA.MAX_HEAD_DIM + 8, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        CA.ring_block_fwd(wide, wide, wide, pos, pos)


# ---------------------------------------------------------------------------
# The f32 routes of K7 and K8 (3xTF32 on mma.sync, csrc/attention_tf32.cuh)


def _close_f32(got, want, name):
    """The f32 kernels' limits, as ``chip_smoke.py`` holds them: max
    |got - want| <= 1e-4 x max(1, max |want|), and the scaled error."""
    got, want = got.float().cpu(), want.float().cpu()
    err = float((got - want).abs().max())
    assert err <= 1e-4 * max(1.0, float(want.abs().max())), (name, err)
    _close_scaled(got, want, SCALED_F32, name)


def _k7_f32_check(q, k, v, do, causal):
    """K7's f32 forward, dq and dk/dv against the plain versions."""
    out, lse, got, want = _bwd_on(q, k, v, do, causal)
    want_out, want_lse = CA.attention_fwd_plain(q, k, v, causal,
                                                q.shape[-1] ** -0.5)
    _close_f32(out, want_out, "out")
    _close_f32(lse, want_lse, "lse")
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        _close_f32(g, w, name)


def _f32_calls(dev, which):
    """One f32 kernel's call on fixed inputs (B 2, S 300, 2 heads x 64,
    causal; K8's keys shuffled with padding inside tiles)."""
    gen = torch.Generator().manual_seed(12)
    q, k, v, do = _attn_inputs(gen, dev, 2, 300, 300, 2, 64, torch.float32)
    out, lse = CA.attention_fwd(q, k, v, True, out_dtype=torch.float32)
    delta = (do * out).sum(-1).transpose(1, 2).contiguous()
    q_pos, k_pos = _any_positions(dev, 2, 300, 300, "shuffled", 5)
    o, m, l = CA.ring_block_fwd(q, k, v, q_pos, k_pos, True)
    rlse = torch.where(l > 0, m + torch.log(l.clamp(min=1e-30)), 1e30)
    ring = (q, k, v, do, rlse, delta, q_pos, k_pos, True)
    return {"k7 fwd": lambda: CA.attention_fwd(q, k, v, True),
            "k7 dq": lambda: CA.attention_bwd_dq(q, k, v, do, lse, delta,
                                                 True),
            "k7 dkdv": lambda: CA.attention_bwd_dkdv(q, k, v, do, lse,
                                                     delta, True),
            "k8 fwd": lambda: CA.ring_block_fwd(q, k, v, q_pos, k_pos,
                                                True),
            "k8 dq": lambda: CA.ring_block_bwd_dq(*ring),
            "k8 dkdv": lambda: CA.ring_block_bwd_dkdv(*ring)}[which]


@pytest.mark.parametrize("which", ["k7 fwd", "k7 dq", "k7 dkdv", "k8 fwd",
                                   "k8 dq", "k8 dkdv"])
def test_f32_attention_kernels_repeat_bitwise(dev, which):
    """Every sum in a fixed order, no atomics: two launches of each f32
    kernel on the same inputs give the same bits."""
    fn = _f32_calls(dev, which)
    first, second = fn(), fn()
    torch.cuda.synchronize()
    for a, b in zip(first if isinstance(first, tuple) else (first,),
                    second if isinstance(second, tuple) else (second,)):
        assert torch.equal(a, b), which


@pytest.mark.parametrize("s", [1024, 4096])
def test_f32_attention_at_the_parity_shapes(dev, s):
    """K7 in f32 at the f32 train parity step's B 2 x S 1024 and the ring
    parity's B 2 x S 4096 (8 heads x 64, causal): dk/dv sums up to 4096
    products, held to the f32 limits."""
    gen = torch.Generator().manual_seed(s)
    q, k, v, do = _attn_inputs(gen, dev, 2, s, s, 8, 64, torch.float32)
    _k7_f32_check(q, k, v, do, True)


@pytest.mark.parametrize("step", range(4))
def test_f32_ring_steps_at_the_parity_shape(dev, step):
    """K8 in f32 at the hosted {"seq": 4} ring's launch shape (B 8 = 4
    ranks x 2, S_local 1024, 8 heads x 64): ring step t, rank r's rows
    against rank (r - t) mod 4's keys (diagonal, full and dead rows)."""
    b, s, ranks = 8, 1024, 4
    gen = torch.Generator().manual_seed(40 + step)
    q, k, v, do = _attn_inputs(gen, dev, b, s, s, 8, 64, torch.float32)
    rank = torch.arange(ranks, dtype=torch.int32).repeat_interleave(b // 4)
    ar = torch.arange(s, dtype=torch.int32)
    q_pos = (rank[:, None] * s + ar).to(dev)
    k_pos = (((rank - step) % ranks)[:, None] * s + ar).to(dev)
    dead, (dq, _, _) = _check_ring_block(q, k, v, do, q_pos, k_pos, True)
    assert bool(dead.any()) == (step > 0)
    assert bool((dq.transpose(1, 2)[dead] == 0).all())


@pytest.mark.parametrize("d", [16, 36, 63])
def test_f32_attention_takes_unaligned_rows(dev, d):
    """f32 tensors whose storage starts 4 bytes past an allocation (and
    Dh 63: rows that are no multiple of 16 bytes): the 3xTF32 kernels
    stage through 4-byte copies and store element by element, and agree
    with the plain versions as aligned rows do; Sq != Sk for K7, shuffled
    keys with padding inside tiles for K8."""
    gen = torch.Generator().manual_seed(d)

    def shifted(s):
        n = 2 * s * 2 * d
        flat = torch.randn(n + 1, generator=gen).to(dev)
        return flat[1:].view(2, s, 2, d)

    q, do = shifted(150), shifted(150)
    k, v = shifted(170), shifted(170)
    assert q.data_ptr() % 16
    _k7_f32_check(q, k, v, do, True)
    k, v = shifted(150), shifted(150)
    q_pos, k_pos = _any_positions(dev, 2, 150, 150, "shuffled", d)
    _check_ring_block(q, k, v, do, q_pos, k_pos, True)


# ---------------------------------------------------------------------------
# K9, the GBDT histogram


def _hist_inputs(dev, n, f, b, density, seed, n_bins_layout=None):
    """K9's inputs; ``n_bins_layout`` as prepare_bins_t's ``n_bins``
    (None: int32 bins, ``b``: uint8 where b <= 256)."""
    rng = np.random.default_rng(seed)
    bins = CH.prepare_bins_t(torch.from_numpy(
        rng.integers(0, b, size=(n, f)).astype(np.int32)),
        n_bins_layout).to(dev)
    grad = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev)
    hess = torch.from_numpy(rng.uniform(0.1, 1, n).astype(np.float32)).to(dev)
    if density == "one":
        mask = torch.zeros(n, dtype=torch.bool)
        mask[n // 3] = True
    else:
        mask = torch.from_numpy(rng.uniform(size=n) < density)
    return bins, grad, hess, mask.to(dev), f, b


def _hist_check(got, args):
    """K9's limit: counts exact; grad and hess within 1e-5 x (the bin's
    sum of |value|) + 1e-6 of the plain version."""
    bins, grad, hess, mask, f, b = args
    want = CH.build_histogram_plain(*args)
    scale = CH.build_histogram_plain(bins, grad.abs(), hess.abs(), mask, f, b)
    assert torch.equal(got[..., 2], want[..., 2]), "counts differ"
    err = (got[..., :2] - want[..., :2]).abs()
    assert bool((err <= 1e-5 * scale[..., :2] + 1e-6).all()), \
        f"grad/hess off by {float(err.max())}"


# (n, F, B) in both layouts where B <= 256: uint8 only holds 256 bins.
# 300001 rows span several clusters and an odd tail word of uint8 bins.
HIST_CASES = [(n, f, b, layout)
              for n, f, b in [(777, 11, 37), (5000, 9, 255),
                              (70000, 3, 2048), (31, 20, 2),
                              (300001, 28, 256)]
              for layout in ("int32", "uint8")
              if layout == "int32" or b <= 256]


@pytest.mark.parametrize("density", [0.7, 0.0, "one", 1 / 64])
@pytest.mark.parametrize("n,f,b,layout", HIST_CASES)
def test_gbdt_histogram_matches_plain_and_repeats(dev, n, f, b, layout,
                                                  density):
    args = _hist_inputs(dev, n, f, b, density, seed=n + b,
                        n_bins_layout=b if layout == "uint8" else None)
    assert args[0].dtype == getattr(torch, layout)
    before = CH.LAUNCHES["gbdt_histogram"]
    got = CH.build_histogram_cuda(*args)
    again = CH.build_histogram_cuda(*args)
    torch.cuda.synchronize()
    assert CH.LAUNCHES["gbdt_histogram"] == before + 2
    assert got.shape == (f, b, 3) and got.dtype == torch.float32
    _hist_check(got, args)
    assert torch.equal(got, again), "two launches differ"


@pytest.mark.parametrize("layout", ["int32", "uint8"])
def test_gbdt_histogram_up_to_8192_rows_is_the_cpu_plain_bitwise(dev,
                                                                  layout):
    """Up to 8192 rows run in one block, which adds each row to its bin in
    row order as the plain version does on the CPU: the same bits."""
    n, f, b = 8192, 5, 255
    args = _hist_inputs(dev, n, f, b, 0.6, seed=7,
                        n_bins_layout=b if layout == "uint8" else None)
    got = CH.build_histogram_cuda(*args)
    cpu = CH.build_histogram_plain(*(a.cpu() for a in args[:4]), f, b)
    assert torch.equal(got.cpu(), cpu)


def test_gbdt_histogram_max_feats(dev):
    """The kernel's own limit on features a block, from its shared-memory
    layout, is what the plan's CPU test assumes (MAX_FEATS in
    test_torch_gbdt_hist.py, which imports JAX), and a block of that many
    features at that bin count launches and is right."""
    want = {2: 32, 37: 32, 255: 29, 256: 29, 2048: 5}
    assert {b: CH.max_feats(b) for b in want} == want
    for b, f in want.items():
        args = _hist_inputs(dev, 9000, f, b, 0.5, seed=b)
        assert CH.plan_for(dev, args[0], f, b).groups == 1
        _hist_check(CH.build_histogram_cuda(*args), args)


def test_gbdt_histogram_check_fails_a_zero_output(dev):
    args = _hist_inputs(dev, 777, 11, 37, 0.7, seed=3)
    with pytest.raises(AssertionError):
        _hist_check(torch.zeros(11, 37, 3, device=dev), args)


def test_gbdt_histogram_refuses_cpu_mixes_and_bad_bins(dev):
    bins, grad, hess, mask, f, b = _hist_inputs(dev, 64, 3, 8, 0.7, seed=4)
    with pytest.raises(ValueError):
        CH.build_histogram_cuda(bins, grad.cpu(), hess, mask, f, b)
    with pytest.raises(ValueError):
        CH.build_histogram_cuda(bins, grad, hess, mask, f, CH.MAX_BINS + 1)


@pytest.mark.parametrize("max_bin,layout", [(255, torch.uint8),
                                             (400, torch.int32)])
def test_gbdt_fit_on_the_card_bins_by_bin_count(dev, max_bin, layout,
                                                monkeypatch):
    """Booster.train lays its bins out as uint8 while the bin count is at
    most 256 and as int32 above, and a fit from uint8 bins gives the same
    trees as one from int32 bins."""
    from mmlspark_tpu_torch.gbdt import booster as BM
    rng = np.random.default_rng(1)
    X = rng.normal(size=(6000, 5))
    y = (X[:, 0] - X[:, 2] + rng.logistic(size=6000) > 0).astype(float)
    p = BoosterParams(objective="binary", num_iterations=4, num_leaves=15,
                      max_bin=max_bin)
    made = []

    def recording(bins, n_bins=None):
        made.append(CH.prepare_bins_t(bins, n_bins))
        return made[-1]

    monkeypatch.setattr(BM, "prepare_bins_t", recording)
    laid_out = Booster.train(p, X, y)
    assert [t.dtype for t in made] == [layout]
    monkeypatch.setattr(BM, "prepare_bins_t",
                        lambda bins, n_bins=None: CH.prepare_bins_t(bins))
    as_int32 = Booster.train(p, X, y)
    assert laid_out.model_to_string() == as_int32.model_to_string()


def test_gbdt_fit_on_the_card_launches_one_histogram_per_leaf(dev):
    """A fused fit launches K9 exactly iterations x leaves times, gives
    the same trees twice, and predicts as its CPU copy does."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(3000, 6))
    y = (X[:, 0] + 0.5 * X[:, 1] + rng.logistic(size=3000) > 0).astype(float)
    p = BoosterParams(objective="binary", num_iterations=5, num_leaves=15)
    before = CH.LAUNCHES["gbdt_histogram"]
    b1 = Booster.train(p, X, y)
    assert CH.LAUNCHES["gbdt_histogram"] == before + 5 * 15
    b2 = Booster.train(p, X, y)
    assert b1.model_to_string() == b2.model_to_string()
    cpu = Booster.from_string(b1.model_to_string(), device="cpu")
    np.testing.assert_allclose(b1.predict(X), cpu.predict(X), atol=1e-5)

