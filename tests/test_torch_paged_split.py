"""K1's and K3's split of the lane across blocks, on the CPU.

The kernels split a lane's keys across blocks and merge the splits'
softmax partials in a second kernel. Here the host-side plans
(:func:`paged_decode_plan`, :func:`paged_prefix_plan`) must cover every
live page or key exactly once and fill the card at the decode path's
shapes, and the merge's plain version, run on per-split partials of the
plain math, must match the JAX Pallas kernels in interpret mode and the
whole-lane plain versions within f32 reassociation (1e-5), at the sizes
of ``test_torch_attention.py``. The kernels themselves are held against
these on the card (``test_torch_kernels_gpu.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.parallel.pallas_attention import (
    paged_decode_attention as jax_paged_decode,
    paged_prefix_prefill_attention as jax_paged_prefix,
)
from mmlspark_tpu_torch.parallel import cuda_attention as CA

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
H, D = 2, 8
# the decode path's shape (chip_smoke.py: 8 slots, max_len 1024, page 16,
# 8 heads; prompts on 256-token preambles)
N_SLOTS, PAGE, PPS, HEADS = 8, 16, 64, 8


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _live_splits(pos, page_size, pages_per_split):
    """The splits a K1 block reads for a slot at ``pos``: those whose first
    page holds a row at or before pos."""
    return pos // page_size // pages_per_split + 1


class TestDecodePlan:

    @pytest.mark.parametrize("n,pps,ps", [(3, 4, 8), (8, 64, 16),
                                          (64, 64, 8), (1, 1, 4),
                                          (200, 33, 16)])
    def test_every_live_page_in_exactly_one_split(self, n, pps, ps):
        per, n_splits = CA.paged_decode_plan(n, pps)
        assert per >= 1 and (n_splits - 1) * per < pps <= n_splits * per
        for pos in range(pps * ps):
            owners = [j for j in range(n_splits)
                      for p in range(j * per, min(pps, (j + 1) * per))
                      if p <= pos // ps]
            pages = sorted(p for j in range(n_splits)
                           for p in range(j * per, min(pps, (j + 1) * per))
                           if p <= pos // ps)
            assert pages == list(range(pos // ps + 1))  # once each
            # splits are live only up to pos's page
            live = _live_splits(pos, ps, per)
            assert sorted(set(owners)) == list(range(live))
            assert live * per * ps > pos >= (live - 1) * per * ps

    def test_fills_the_card_at_the_decode_path(self):
        per, n_splits = CA.paged_decode_plan(N_SLOTS, PPS)
        # the path's positions: prompts of 272 + 5 i tokens, half way
        # through 48 new tokens
        pos = [256 + 16 + 5 * i + 24 for i in range(N_SLOTS)]
        live = sum(_live_splits(p, PAGE, per) for p in pos)
        assert live >= CA.CARD_SMS
        assert n_splits * N_SLOTS >= live
        # a whole lane at the second timed shape, pos about 1000
        assert sum(_live_splits(1000, PAGE, per)
                   for _ in range(N_SLOTS)) >= 3 * CA.CARD_SMS


class TestPrefixPlan:

    @pytest.mark.parametrize("s,hit", [(16, 256), (16, 0), (5, 16),
                                       (64, 256), (33, 512), (64, 1008),
                                       (768, 256), (1008, 16), (1, 1023),
                                       (24, 1000)])
    def test_every_live_key_in_exactly_one_split(self, s, hit):
        lane = PPS * PAGE
        rows, per, n_splits = CA.paged_prefix_plan(s, hit, HEADS, lane)
        kv_end = min(lane, hit + s)
        assert rows == (16 if s <= 16 else 32)
        assert per % (2 * rows) == 0  # whole stages of the kernel
        # the splits cover [0, kv_end) and none starts past it
        assert (n_splits - 1) * per < kv_end <= n_splits * per

    def test_short_suffix_fills_the_card(self):
        rows, per, n_splits = CA.paged_prefix_plan(16, 256, HEADS,
                                                   PPS * PAGE)
        blocks = HEADS * (-(-16 // rows)) * n_splits
        assert blocks >= 64
        assert per == 32  # one 32-key stage a block

    @pytest.mark.parametrize("s,hit", [(768, 256), (1008, 16)])
    def test_long_suffix_keeps_the_keys_whole(self, s, hit):
        rows, per, n_splits = CA.paged_prefix_plan(s, hit, HEADS,
                                                   PPS * PAGE)
        assert n_splits == 1 and per >= min(PPS * PAGE, hit + s)
        assert HEADS * -(-s // rows) >= CA.CARD_SMS


def _decode_inputs(seed, pos, ps=8, pps=4):
    rng = np.random.default_rng(seed)
    n = len(pos)
    n_pages = 1 + n * pps
    kp = rng.normal(size=(n_pages, ps, H, D)).astype(np.float32)
    vp = rng.normal(size=(n_pages, ps, H, D)).astype(np.float32)
    q = rng.normal(size=(n, H, D)).astype(np.float32)
    tables = rng.permutation(np.arange(1, n_pages)).reshape(n, pps) \
        .astype(np.int32)
    return q, kp, vp, tables, np.asarray(pos, np.int32)


def _jax_decode(q, kp, vp, tables, pos, ps=8):
    return np.asarray(jax_paged_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(pos), scale=D ** -0.5,
        page_size=ps, interpret=True))


class TestDecodeMerge:

    # pos 0, the lane end (31), page and split edges; 1 page a split up to
    # the whole lane (4 pages: a single split)
    @pytest.mark.parametrize("pos", [[0, 17, 31], [7, 8, 0], [31, 31, 16],
                                     [15, 16, 23]])
    @pytest.mark.parametrize("per", [1, 2, 3, 4])
    def test_merged_partials_match_jax_and_the_whole_lane(self, pos, per):
        q, kp, vp, tables, p = _decode_inputs(sum(pos), pos)
        args = (_t(q), _t(kp), _t(vp), _t(tables, torch.int32),
                _t(p, torch.int32), D ** -0.5, 8)
        m, l, acc = CA.paged_decode_partials_plain(*args, per)
        got = CA.paged_merge_partials_plain(m, l, acc)
        np.testing.assert_allclose(got.numpy(), _jax_decode(q, kp, vp,
                                                            tables, p),
                                   **TOL)
        torch.testing.assert_close(
            got, CA.paged_decode_attention_plain(*args), **TOL)

    def test_splits_past_pos_are_empty_and_weigh_nothing(self):
        pos = [0, 9, 31]
        q, kp, vp, tables, p = _decode_inputs(5, pos)
        args = (_t(q), _t(kp), _t(vp), _t(tables, torch.int32),
                _t(p, torch.int32), D ** -0.5, 8)
        m, l, acc = CA.paged_decode_partials_plain(*args, 1)
        for i, pi in enumerate(pos):
            live = _live_splits(pi, 8, 1)
            assert (m[i, live:] == -1e30).all()
            assert (l[i, live:] == 0).all() and (acc[i, live:] == 0).all()
            assert (l[i, :live] > 0).all()
        # the merge of the live splits alone, as the kernel reads them
        live = _live_splits(0, 8, 1)
        alone = CA.paged_merge_partials_plain(m[:1, :live], l[:1, :live],
                                              acc[:1, :live])
        assert torch.equal(alone, CA.paged_merge_partials_plain(
            m, l, acc)[:1])
        # pos 0 sees row 0 of its first page alone: its value row
        v0 = _t(vp)[int(tables[0, 0]), 0]
        torch.testing.assert_close(alone[0], v0, **TOL)

    def test_free_slots_on_the_scratch_page(self):
        q, kp, vp, tables, p = _decode_inputs(9, [0, 30, 0])
        tables[0] = tables[2] = 0
        args = (_t(q), _t(kp), _t(vp), _t(tables, torch.int32),
                _t(p, torch.int32), D ** -0.5, 8)
        got = CA.paged_merge_partials_plain(
            *CA.paged_decode_partials_plain(*args, 2))
        np.testing.assert_allclose(got.numpy(), _jax_decode(q, kp, vp,
                                                            tables, p),
                                   **TOL)


def _prefix_inputs(seed, pps, hit_pages, suffix, ps=8):
    rng = np.random.default_rng(seed)
    bucket = 1
    while bucket < suffix:
        bucket *= 2
    kp = rng.normal(size=(1 + pps, ps, H, D)).astype(np.float32)
    vp = rng.normal(size=(1 + pps, ps, H, D)).astype(np.float32)
    q = rng.normal(size=(bucket, H, D)).astype(np.float32)
    table = rng.permutation(np.arange(1, 1 + pps)).astype(np.int32)
    return q, kp, vp, table, hit_pages * ps


class TestPrefixMerge:

    # the cases of test_torch_attention.py; keys split by a page, two
    # pages, and the whole 32-key tile (a single split at 4 pages)
    @pytest.mark.parametrize("pps,hit_pages,suffix", [
        (4, 1, 11), (4, 2, 5), (7, 4, 17), (4, 0, 16)])
    @pytest.mark.parametrize("per", [8, 16, 32])
    def test_merged_partials_match_jax_and_the_whole_lane(
            self, pps, hit_pages, suffix, per):
        q, kp, vp, table, hit = _prefix_inputs(pps + suffix, pps,
                                               hit_pages, suffix)
        args = (_t(q), _t(kp), _t(vp), _t(table, torch.int32), hit,
                D ** -0.5, 8)
        m, l, acc = CA.paged_prefix_partials_plain(*args, per)
        got = CA.paged_merge_partials_plain(m, l, acc)
        kern = jax_paged_prefix(jnp.asarray(q), jnp.asarray(kp),
                                jnp.asarray(vp), jnp.asarray(table),
                                jnp.int32(hit), scale=D ** -0.5,
                                page_size=8, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(kern), **TOL)
        torch.testing.assert_close(
            got, CA.paged_prefix_prefill_attention_plain(*args), **TOL)

    def test_rows_see_no_key_of_later_splits(self):
        q, kp, vp, table, hit = _prefix_inputs(3, 4, 1, 11)
        args = (_t(q), _t(kp), _t(vp), _t(table, torch.int32), hit,
                D ** -0.5, 8)
        m, l, acc = CA.paged_prefix_partials_plain(*args, 8)
        for row in range(q.shape[0]):
            live = (hit + row) // 8 + 1
            assert (m[row, live:] == -1e30).all()
            assert (l[row, live:] == 0).all()
            assert (l[row, :live] > 0).all()
