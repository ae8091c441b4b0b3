"""The pure-Python launch plans of the attention kernels: K1's q tile and grid
(`attention_plan`), K2's head blocks, split plan and shared memory
(`head_blocks`, `split_plan`, `decode_layout`).  The kernels take their tiles
from these plans, so what is checked here is what the card will launch:
every query row, every key and every head is covered exactly once, the grid
reaches the block count it aims at, and the shared memory a plan asks for
fits one block's 227 KB."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import HEAD_DIMS, N_SMS, SMEM_LIMIT
from repro_torch.kernels.flash_attention import \
    TARGET_BLOCKS as ATTENTION_TARGET
from repro_torch.kernels.flash_attention import attention_plan
from repro_torch.kernels.flash_decode import (MAX_HEADS, MIN_CHUNK,
                                              TARGET_BLOCKS, decode_layout,
                                              head_blocks, split_plan)

DTYPES = [torch.float32, torch.bfloat16]
# (B, S, H): the serving paths' prefills (qwen3-1.7b, zamba2-1.2b), the long
# shape, S below 16, S a multiple of no tile, a batch that fills the card
SHAPES = [(1, 256, 16), (1, 512, 32), (1, 4096, 16), (1, 5, 2), (2, 333, 10),
          (4, 300, 16), (1, 77, 4)]


def _covered(tiles, lo, hi):
    """The tiles are consecutive, disjoint and cover [lo, hi) exactly."""
    assert tiles, (lo, hi)
    assert tiles[0][0] <= lo and tiles[-1][1] == hi
    for (a0, a1), (b0, _) in zip(tiles, tiles[1:]):
        assert a1 == b0 and a0 < a1
    return True


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("b,s,h", SHAPES)
def test_attention_plan_covers_every_query_row_once(b, s, h, hd, dtype):
    plan = attention_plan(b, s, h, hd, dtype)
    tiles = plan.q_tiles(s)
    assert tiles[0][0] == 0 and _covered(tiles, 0, s)
    assert all(q1 - q0 <= plan.bq for q0, q1 in tiles)
    assert plan.grid == (len(tiles), h, b)


@pytest.mark.parametrize("causal,window", [(True, -1), (False, -1), (True, 0),
                                           (False, 0), (True, 24), (False, 24),
                                           (True, 100)])
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("b,s,h", SHAPES)
def test_attention_plan_walks_every_visible_key_once(b, s, h, hd, causal,
                                                     window):
    """Each q tile's kv tiles cover every key that one of its rows can see,
    each once; with no causal limit and no window (or window 0, where every
    key is masked and the row is the mean of V) they cover all of [0, S)."""
    for dtype in DTYPES:
        plan = attention_plan(b, s, h, hd, dtype)
        for q0, q1 in plan.q_tiles(s):
            tiles = plan.key_tiles(s, q0, causal, window)
            assert all(k0 % plan.bk == 0 and k1 - k0 <= plan.bk
                       for k0, k1 in tiles)
            dist = np.arange(q0, q1)[:, None] - np.arange(s)[None, :]
            ok = np.ones_like(dist, dtype=bool)
            if window != 0:
                if causal:
                    ok &= dist >= 0
                if window > 0:
                    ok &= dist < window
            visible = np.nonzero(ok.any(axis=0))[0]
            lo, hi = visible[0], visible[-1] + 1
            assert _covered(tiles, lo, tiles[-1][1])
            assert tiles[0][0] <= lo and tiles[-1][1] >= hi
            # no tile lies wholly outside what the rows can see
            assert tiles[0][0] + plan.bk > lo and tiles[-1][0] < hi
            if window == 0 or (not causal and window < 0):
                assert tiles[0][0] == 0 and tiles[-1][1] == s


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("b,s,h", SHAPES)
def test_attention_plan_reaches_the_blocks_it_aims_at(b, s, h, hd):
    """bf16: 8 warps a block; the most row warps (8, 4, 2) whose grid leaves
    at most a tenth of the SMs without a block, where none does 2; the other
    warps split the kv range."""
    plan = attention_plan(b, s, h, hd, torch.bfloat16)
    rows = plan.bq // 16
    assert plan.target_blocks == ATTENTION_TARGET == N_SMS - N_SMS // 10
    assert plan.warps == 8
    assert rows in (8, 4, 2) and rows * plan.kv_warps == plan.warps
    if plan.blocks < plan.target_blocks:
        assert rows == 2
    if rows < 8:                # one more doubling of the q tile falls short
        assert -(-s // (32 * rows)) * h * b < plan.target_blocks
    assert plan.bk == (64 if plan.kv_warps == 1 or hd <= 64 else 32) // (
        2 if hd == 256 else 1)


def test_attention_plan_at_the_serving_paths():
    qwen3 = attention_plan(1, 256, 16, 128, torch.bfloat16)
    assert (qwen3.bq, qwen3.kv_warps, qwen3.blocks) == (32, 4, 128)
    # olmoe-1b-7b's prefill (16 q heads as qwen3's, but 16 kv heads: the
    # plan is by q head, so it is qwen3's)
    olmoe = attention_plan(1, 256, 16, 128, torch.bfloat16)
    assert (olmoe.bq, olmoe.kv_warps, olmoe.bk, olmoe.grid) == (32, 4, 32,
                                                                (8, 16, 1))
    zamba2 = attention_plan(1, 512, 32, 64, torch.bfloat16)
    assert (zamba2.bq, zamba2.kv_warps, zamba2.bk, zamba2.blocks) == (128, 1,
                                                                      64, 128)
    long = attention_plan(1, 4096, 16, 128, torch.bfloat16)
    assert (long.bq, long.kv_warps, long.bk) == (128, 1, 64)
    f32 = attention_plan(1, 256, 16, 128, torch.float32)
    assert (f32.bq, f32.bk, f32.kv_warps) == (64, 64, 1)


def test_attention_plan_at_the_four_later_serving_paths():
    """gemma3-4b's prefill (S 1536, head_dim 256: the kv tile halved) and
    the 256-token prefills of qwen2.5-14b, llama4-scout-17b-a16e (40 q
    heads) and mistral-large-123b (96).  Under gemma3-4b's window of 1024
    the last q tile walks the kv tiles from the window's lower edge only."""
    gemma3 = attention_plan(1, 1536, 8, 256, torch.bfloat16)
    assert (gemma3.bq, gemma3.bk, gemma3.kv_warps, gemma3.grid) == \
        (64, 16, 2, (24, 8, 1))
    q0, q1 = gemma3.q_tiles(1536)[-1]
    windowed = gemma3.key_tiles(1536, q0, True, 1024)
    assert windowed[0][0] == q0 - 1024 + 1 - (q0 - 1024 + 1) % 16
    assert len(windowed) == 68 and len(gemma3.key_tiles(1536, q0, True,
                                                        -1)) == 96
    for h in (40, 96):
        plan = attention_plan(1, 256, h, 128, torch.bfloat16)
        assert plan.blocks >= plan.target_blocks
    assert attention_plan(1, 256, 96, 128, torch.bfloat16).bq == 128


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_attention_plan_shared_memory_fits(hd, dtype):
    """Every head_dim has a plan in both dtypes, and the shared memory it asks
    for (from its tile sizes: bf16 Q and three stages of a K and a V tile
    for each kv warp, rows padded by 8 elements, or the f32 merge area if that is
    larger; f32 Q, K, V and P, rows padded by 4) fits one block."""
    for s in (5, 256, 600, 4096):
        plan = attention_plan(1, s, 16, hd, dtype)
        if dtype == torch.bfloat16:
            want = max(2 * (hd + 8) * (plan.bq + 6 * plan.kv_warps * plan.bk),
                       4 * plan.warps * 16 * (hd + 6))
        else:
            want = 4 * ((plan.bq + plan.bk) * (hd + 4) + plan.bk * hd
                        + plan.bq * (plan.bk + 4))
        assert plan.smem_bytes == want <= SMEM_LIMIT


@pytest.mark.parametrize("group", [1, 2, 3, 5, 6, 7, 8, 9, 12, 16, 24])
def test_head_blocks_cover_the_group_once(group):
    n, per = head_blocks(group)
    assert per <= MAX_HEADS and n * per >= group > (n - 1) * per
    heads = [h for blk in range(n)
             for h in range(blk * per, min(group, (blk + 1) * per))]
    assert heads == list(range(group))
    assert n == -(-group // MAX_HEADS)        # no more cache reads than needed


@pytest.mark.parametrize("b,kv,s", [(8, 8, 1024), (8, 32, 1024), (8, 8, 8192),
                                    (8, 16, 1024),
                                    (1, 1, 50), (3, 2, 700), (64, 8, 100),
                                    (1, 8, 4096), (2, 1, 33), (1, 1, 1)])
def test_split_plan_covers_every_key_once(b, kv, s):
    tile = 32
    n_splits, chunk = split_plan(b, kv, s, tile)
    splits = [(i * chunk, min(s, (i + 1) * chunk)) for i in range(n_splits)]
    assert splits[0][0] == 0 and _covered(splits, 0, s)
    assert chunk % tile == 0 and chunk <= -(-s // tile) * tile
    # it aims at TARGET_BLOCKS blocks: the largest power of two of splits a
    # row that keeps the grid within them, unless a chunk would then be
    # shorter than MIN_CHUNK keys (or the cache is shorter than that)
    want = 1
    while 2 * want * b * kv <= TARGET_BLOCKS:
        want *= 2
    assert want * b * kv <= TARGET_BLOCKS or want == 1
    assert chunk >= min(MIN_CHUNK, -(-s // tile) * tile)
    assert n_splits <= want
    if chunk > MIN_CHUNK and chunk < -(-s // tile) * tile:
        assert -(-s // (chunk - tile)) > want      # no smaller chunk would do


def test_split_plan_at_the_serving_paths():
    assert split_plan(8, 8, 1024, 32) == (8, 128)       # qwen3-1.7b decode
    assert split_plan(8, 32, 1024, 32) == (2, 512)      # zamba2-1.2b decode
    assert split_plan(8, 16, 1024, 32) == (4, 256)      # olmoe-1b-7b decode
    assert head_blocks(16 // 16) == (1, 1)              # olmoe: MHA, group 1
    assert split_plan(8, 8, 8192, 32) == (8, 1024)      # the long shape


def test_split_plan_at_the_four_later_serving_paths():
    assert split_plan(8, 4, 2048, 32) == (16, 128)      # gemma3-4b decode
    # qwen2.5-14b, llama4-scout-17b-a16e, mistral-large-123b: 8 kv heads
    assert split_plan(8, 8, 1024, 32) == (8, 128)
    assert head_blocks(8 // 4) == (1, 2)                # gemma3-4b: group 2
    assert head_blocks(40 // 8) == (1, 5)               # qwen2.5, llama4
    assert head_blocks(96 // 8) == (2, 6)               # mistral: two blocks


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_decode_layout_fits(hd, dtype):
    """A key row is hd * elt / 16 lanes of 16 bytes, at most a warp; the
    shared memory (the warps' rings, reused for the merge of up to MAX_HEADS
    heads) fits one block."""
    lay = decode_layout(hd, dtype)
    elt = 4 if dtype == torch.float32 else 2
    assert lay["lanes_per_key"] * lay["segments_per_lane"] * 16 == hd * elt
    assert lay["lanes_per_key"] * lay["keys_per_step"] == 32
    assert lay["smem_bytes"] <= SMEM_LIMIT


# ---- K3: ssd_plan -----------------------------------------------------------

from repro_torch.kernels.ssd import (PAIR_WAVES, T_TILE,  # noqa: E402
                                     TC_BLOCKS_PER_SM, TC_HEADS, chunking,
                                     ssd_plan, tc_smem_bytes)
from repro_torch.kernels.ssd import TARGET_BLOCKS as SSD_TARGET  # noqa: E402

# (B, S, nh, hp, N, chunk): chip_smoke.sweep_ssd's shapes, then the serving
# paths' prefills (mamba2-780m, zamba2-1.2b)
SSD_SHAPES = [(1, 64, 2, 16, 8, 16), (2, 96, 3, 16, 8, 32),
              (1, 80, 4, 32, 16, 32), (2, 40, 3, 16, 8, 64),
              (1, 512, 4, 64, 128, 256), (2, 300, 5, 64, 64, 256),
              (1, 1000, 2, 32, 128, 256), (3, 7, 2, 16, 4, 16),
              (1, 512, 48, 64, 128, 256), (1, 512, 64, 64, 64, 256)]
SSD_SERVING = SSD_SHAPES[-2:]


def _ssd_plans(b, s, nh, hp, n, chunk):
    """Every plan the wrapper or chip_smoke's plans phase can launch."""
    yield ssd_plan(b, s, nh, hp, n, chunk, torch.float32)
    yield ssd_plan(b, s, nh, hp, n, chunk, torch.bfloat16)
    for g in TC_HEADS[hp]:
        for pair in (False, True):
            yield ssd_plan(b, s, nh, hp, n, chunk, torch.bfloat16,
                           heads_per_block=g, pair=pair)


@pytest.mark.parametrize("b,s,nh,hp,n,chunk", SSD_SHAPES)
def test_ssd_plan_covers_every_causal_pair_once(b, s, nh, hp, n, chunk):
    """Every (t, s <= t) pair of every (batch, chunk, head) is walked by
    exactly one block, and no pair above the diagonal is: a block that writes
    the y rows of t tile tt (those before the chunk's last valid step) walks
    the s tiles 0..tt."""
    q, nc, _ = chunking(s, chunk)
    for plan in _ssd_plans(b, s, nh, hp, n, chunk):
        counts = np.zeros((b, nc, nh, q, q), dtype=np.int32)
        for blk in plan.blocks_list():
            valid = min(q, s - blk["c"] * q)
            for tt in blk["t_tiles"]:
                t0, t1 = tt * T_TILE, min(valid, (tt + 1) * T_TILE)
                s1 = min(q, (tt + 1) * T_TILE)
                assert t0 < t1
                for h in blk["heads"]:
                    counts[blk["b"], blk["c"], h, t0:t1, :s1] += 1
        for c in range(nc):
            valid = min(q, s - c * q)
            t = np.arange(q)[:, None]
            u = np.arange(q)[None, :]
            want = ((u <= t) & (t < valid)).astype(np.int32)
            got = np.where(u <= t, counts[:, c], 0)
            assert (got == want).all(), (plan, c)


@pytest.mark.parametrize("b,s,nh,hp,n,chunk", SSD_SHAPES)
def test_ssd_plan_writes_every_state_once(b, s, nh, hp, n, chunk):
    """s_chunk, cum and decay of every (batch, chunk, head) come from exactly
    one block, and the grid's y items and state items are disjoint."""
    q, nc, _ = chunking(s, chunk)
    for plan in _ssd_plans(b, s, nh, hp, n, chunk):
        seen = {}
        for blk in plan.blocks_list():
            if blk["states"]:
                assert len(blk["heads"]) == 1
                key = (blk["b"], blk["c"], blk["heads"][0])
                seen[key] = seen.get(key, 0) + 1
            if plan.route == "tc":
                assert blk["states"] != bool(blk["t_tiles"])
        assert seen == {(i, c, h): 1 for i in range(b) for c in range(nc)
                        for h in range(nh)}, plan


@pytest.mark.parametrize("b,s,nh,hp,n,chunk", SSD_SHAPES)
def test_ssd_plan_reaches_the_blocks_it_aims_at(b, s, nh, hp, n, chunk):
    """bf16: the largest head group whose grid has a block for every SM;
    a smaller group only where the larger one falls short; a long and a
    short t tile paired only where the unpaired grid takes more than
    PAIR_WAVES waves of TC_BLOCKS_PER_SM blocks an SM."""
    plan = ssd_plan(b, s, nh, hp, n, chunk, torch.bfloat16)
    assert plan.route == "tc" and plan.target_blocks == SSD_TARGET == N_SMS
    g = plan.heads_per_block
    assert g in TC_HEADS[hp] and g * hp <= 128
    if g > 1:
        unpaired = ssd_plan(b, s, nh, hp, n, chunk, torch.bfloat16,
                            heads_per_block=g, pair=False)
        assert unpaired.blocks >= plan.target_blocks
    for bigger in TC_HEADS[hp]:
        if bigger > g:
            assert ssd_plan(b, s, nh, hp, n, chunk, torch.bfloat16,
                            heads_per_block=bigger,
                            pair=False).blocks < plan.target_blocks
    unpaired = ssd_plan(b, s, nh, hp, n, chunk, torch.bfloat16,
                        heads_per_block=g, pair=False)
    waves = unpaired.blocks / (TC_BLOCKS_PER_SM * N_SMS)
    # paired where the unpaired grid takes more than PAIR_WAVES waves
    assert plan.pair == (plan.n_tt > 1 and waves > PAIR_WAVES
                         and plan.blocks >= plan.target_blocks)


def test_ssd_plan_at_the_serving_paths():
    mamba2 = ssd_plan(*SSD_SERVING[0], torch.bfloat16)
    assert (mamba2.heads_per_block, mamba2.pair, mamba2.grid) == (
        2, False, (24, 2, 6))
    zamba2 = ssd_plan(*SSD_SERVING[1], torch.bfloat16)
    assert (zamba2.heads_per_block, zamba2.pair, zamba2.grid) == (
        2, True, (32, 2, 4))
    for plan in (mamba2, zamba2):
        assert plan.blocks >= plan.target_blocks
        # two blocks fit one SM's shared memory (1 KB each reserved)
        assert TC_BLOCKS_PER_SM * (plan.smem_bytes + 1024) <= 233_472
    f32 = ssd_plan(*SSD_SERVING[0], torch.float32)
    assert (f32.route, f32.grid) == ("f32", (2, 48, 1))


@pytest.mark.parametrize("hp", sorted(TC_HEADS))
@pytest.mark.parametrize("n", [4, 8, 12, 64, 124, 128])
def test_ssd_plan_shared_memory_fits(hp, n):
    """Every plan at every chunk length up to 256 asks for shared memory
    that fits one block, computed from its tiles as the kernel does."""
    for q in (7, 16, 64, 100, 256):
        for g in TC_HEADS[hp]:
            for pair in (False, True):
                plan = ssd_plan(1, q, 8, hp, n, q, torch.bfloat16,
                                heads_per_block=g, pair=pair)
                qp = -(-q // 64) * 64
                ldb, ldx = -(-n // 16) * 16 + 8, g * hp + 8
                want = 4 * (3 * g * qp + qp) + 2 * 64 * ldb + \
                    2 * 2 * 64 * (ldb + ldx)
                assert plan.smem_bytes == tc_smem_bytes(hp, g, q, n) == want
                assert want <= SMEM_LIMIT
        f32 = ssd_plan(1, q, 8, hp, n, q, torch.float32)
        assert f32.smem_bytes <= SMEM_LIMIT
