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
from mmlspark_tpu_torch.ops import fused_ce as FC
from mmlspark_tpu_torch.parallel import cuda_attention as CA

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


@pytest.mark.parametrize("b,s,h,d", [(2, 1, 3, 8), (2, 63, 3, 8),
                                     (1, 100, 2, 16), (1, 257, 8, 64)])
def test_flash_prefill_matches_plain(dev, b, s, h, d):
    gen = torch.Generator().manual_seed(s)
    args = tuple(_rnd(gen, dev, b, s, h, d) for _ in range(3))
    _launch_and_compare("flash_prefill_attention",
                        CA.flash_prefill_attention,
                        CA.flash_prefill_attention_plain, args)


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
