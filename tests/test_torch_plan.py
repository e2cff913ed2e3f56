"""Host-side launch plans of the port's redesigned kernels, on the CPU.

``ops/adain.py:adain_plan`` (K3, ``csrc/adain_gate.cu``),
``ops/lstm.py:bwd_plan`` (K2, ``csrc/lstm_bwd.cu``), ``ops/lstm.py:
fwd_plan`` (K1, ``csrc/lstm_fwd.cu``) and ``ops/shift_attention.py:
shift_plan`` (K4, ``csrc/shift_attend.cu``) decide tiles, chunks, ring
stages and shared memory in Python, so that these tests reach them
without a card: the main path's shapes plan within a block's shared
memory, the plans use the constants the CUDA sources declare, and shapes
the kernels cannot take raise with the constraint named.  On the card,
``tests/test_torch_kernels.py`` also holds the byte counts against the
kernels' own layout functions.
"""

import re
from pathlib import Path

import pytest

from dasa_tpu_torch.ops import _build
from dasa_tpu_torch.ops.adain import (
    ADAIN_BM,
    ADAIN_SK,
    ADAIN_STAGES,
    ADAIN_THREADS,
    adain_plan,
)
from dasa_tpu_torch.ops.lstm import (
    BWD_MAX_B,
    BWD_PAD,
    BWD_STAGES,
    BWD_THREADS,
    BWD_UNITS,
    FWD_MAX_B,
    FWD_PAD,
    FWD_PAIR_MAX_B,
    FWD_THREADS,
    FWD_UNITS,
    _bwd_smem,
    _fwd_smem,
    bwd_plan,
    fwd_plan,
    max_chunk_rows,
    row_chunks,
)
from dasa_tpu_torch.ops.shift_attention import (
    SHIFT_MAX_B,
    SHIFT_PAD,
    SHIFT_THREADS,
    _shift_smem,
    shift_plan,
)

CSRC = Path(_build.CSRC)
H100_SMS = 132


def _constants(source):
    """The namespace-level ``constexpr int name = value;`` lines of a CUDA
    source, evaluated in order (a value may name an earlier constant)."""
    out = {}
    text = (CSRC / source).read_text()
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", text,
                                 re.M):
        out[name] = eval(expr, {}, dict(out))  # noqa: S307 - our own source
    return text, out


@pytest.mark.parametrize("n,bn,grid", [(720, 128, (16, 6)),
                                       (320, 64, (32, 3))])
def test_adain_headline_plans_fit(n, bn, grid):
    plan = adain_plan(n, 2048, 2048, H100_SMS)
    assert (plan.bn, plan.grid) == (bn, grid)
    assert plan.smem <= _build.MAX_SMEM


# 10: a rank's rows of the headline batch under data parallel at D = 2
@pytest.mark.parametrize("b,stages", [(10, 8), (20, 7), (32, 4)])
def test_lstm_bwd_headline_plans_fit(b, stages):
    plan = bwd_plan(80, b, 1024, H100_SMS)
    assert plan.ctas == 128 and plan.kc == 512 and plan.nchunks == 8
    assert plan.stages == stages
    assert plan.smem == _bwd_smem(80, b, 1024, plan.kc, plan.stages)
    assert plan.smem <= _build.MAX_SMEM
    # one more stage would not fit, unless the ring already holds a row
    assert (plan.stages == plan.nchunks or _bwd_smem(
        80, b, 1024, plan.kc, plan.stages + 1) > _build.MAX_SMEM)


def test_plans_use_the_constants_of_the_cuda_sources():
    text, k3 = _constants("adain_gate.cu")
    assert (k3["kBM"], k3["kSK"], k3["kThreads"]) == (
        ADAIN_BM, ADAIN_SK, ADAIN_THREADS)
    stages = re.search(r"kStages = BN == 128 \? (\d+) : (\d+);", text)
    assert {128: int(stages[1]), 64: int(stages[2])} == ADAIN_STAGES
    _text, k2 = _constants("lstm_bwd.cu")
    assert k2["kUnits"] == BWD_UNITS and k2["kThreads"] == BWD_THREADS
    assert k2["kPad"] == BWD_PAD
    assert k2["kMaxMTiles"] * 16 == BWD_MAX_B


def test_small_card_test_shapes_plan():
    """The card tests' shapes launch too: K2 at H = 64 and 256 (8 and 32
    CTAs), and K3 at C = K = 128 for 1, 64 and 100 rows."""
    small = bwd_plan(16, 3, 64, H100_SMS)
    assert (small.ctas, small.kc, small.nchunks, small.stages) == (8, 256, 1, 1)
    mid = bwd_plan(16, 20, 256, H100_SMS)
    assert (mid.ctas, mid.kc, mid.nchunks, mid.stages) == (32, 512, 2, 2)
    for n in (1, 64, 100):
        assert adain_plan(n, 128, 128, H100_SMS).grid[1] == 1


@pytest.mark.parametrize("args,match", [
    ((720, 96, 2048), "multiple of 64"),
    ((720, 2048, 2044), "multiple of 8"),
    ((0, 2048, 2048), "at least 1"),
])
def test_adain_plan_refuses_shapes_naming_the_constraint(args, match):
    with pytest.raises(ValueError, match=match):
        adain_plan(*args)


@pytest.mark.parametrize("n,c,n_sm,bn", [
    (720, 2048, 132, 128),   # 96 tiles of 128 x 128 fill more than half
    (320, 2048, 132, 64),    # 48 would fill at most half: 96 of 128 x 64
    (320, 2048, 64, 128),    # on a card of 64 SMs 48 tiles are enough
    (720, 192, 132, 64),     # C not a multiple of 128
])
def test_adain_plan_takes_the_wide_tile_only_when_it_fills_the_card(
        n, c, n_sm, bn):
    plan = adain_plan(n, c, 2048, n_sm)
    assert plan.bn == bn and plan.stages == ADAIN_STAGES[bn]
    assert plan.grid == (c // bn, -(-n // ADAIN_BM))


@pytest.mark.parametrize("args,match", [
    ((80, 20, 72, H100_SMS), "multiple of 16"),
    ((80, 65, 1024, H100_SMS), "1..64"),
    ((80, 20, 2048, H100_SMS), "SMs"),
    ((80, 20, 1040, H100_SMS), "at most 32"),
    ((4000, 64, 1024, H100_SMS), "shared memory"),
])
def test_lstm_bwd_plan_refuses_shapes_naming_the_constraint(args, match):
    with pytest.raises(ValueError, match=match):
        bwd_plan(*args)


@pytest.mark.parametrize("t,b", [(80, 64), (200, 20), (35, 1)])
def test_lstm_bwd_plan_keeps_the_deepest_ring_that_fits(t, b):
    plan = bwd_plan(t, b, 1024, H100_SMS)
    assert 1 <= plan.stages <= min(BWD_STAGES, plan.nchunks)
    assert plan.smem == _bwd_smem(t, b, 1024, plan.kc, plan.stages)
    assert plan.smem <= _build.MAX_SMEM
    assert (plan.stages == min(BWD_STAGES, plan.nchunks) or _bwd_smem(
        t, b, 1024, plan.kc, plan.stages + 1) > _build.MAX_SMEM)


@pytest.mark.parametrize("b", [10, 20, 32])
@pytest.mark.parametrize("dirs,units,ctas", [(1, 8, 128), (2, 16, 128)])
def test_lstm_fwd_headline_plans_fit(b, dirs, units, ctas):
    """One direction takes 8 units a CTA (128 CTAs); both directions in
    one launch take 16 (64 CTAs each, 128 on 132 SMs)."""
    plan = fwd_plan(80, b, 1024, H100_SMS, dirs)
    assert (plan.units, plan.ctas) == (units, ctas)
    assert plan.smem == _fwd_smem(80, b, 1024, units)
    assert plan.smem <= _build.MAX_SMEM


@pytest.mark.parametrize("n_sm,dirs,units", [
    (132, 1, 8), (132, 2, 16), (128, 2, 16), (127, 1, 16), (64, 1, 16)])
def test_lstm_fwd_plan_picks_the_grid_from_the_sm_count(n_sm, dirs, units):
    plan = fwd_plan(80, 20, 1024, n_sm, dirs)
    assert plan.units == units and plan.ctas == dirs * 1024 // units
    assert plan.ctas <= n_sm


@pytest.mark.parametrize("t,b,h,dirs", [(1, 3, 64, 1), (16, 20, 256, 2),
                                        (1, 32, 1024, 2), (400, 32, 1024, 1)])
def test_small_and_long_fwd_shapes_plan(t, b, h, dirs):
    """The card tests' shapes launch, and a long sequence still fits."""
    plan = fwd_plan(t, b, h, H100_SMS, dirs)
    assert plan.smem == _fwd_smem(t, b, h, plan.units) <= _build.MAX_SMEM
    assert plan.ctas == dirs * h // plan.units


@pytest.mark.parametrize("args,match", [
    ((80, 20, 1000, H100_SMS, 1), "multiple of 64"),
    ((80, 65, 1024, H100_SMS, 1), "1..64"),
    ((80, 20, 1024, H100_SMS, 3), "one or two"),
    ((80, 20, 2048, H100_SMS, 2), "SMs"),
    ((80, 20, 1024, 32, 2), "SMs"),
    ((2000, 32, 1024, H100_SMS, 2), "shared memory"),
])
def test_lstm_fwd_plan_refuses_shapes_naming_the_constraint(args, match):
    with pytest.raises(ValueError, match=match):
        fwd_plan(*args)


@pytest.mark.parametrize("b", [20, 32, 40, 64])
def test_lstm_fwd_plans_fit_the_stream_width(b):
    """The stream window's 2B = 40 slot rows, and up to 64: a BiLSTM
    plans within a block's shared memory; up to 32 rows both directions
    share one launch of 128 CTAs, above each direction takes its own
    launch of 128 CTAs of 8 units."""
    plan = fwd_plan(80, b, 1024, H100_SMS, 2)
    assert plan.smem == _fwd_smem(80, b, 1024, plan.units) <= _build.MAX_SMEM
    assert plan.ctas == 128
    if b <= 32:
        assert (plan.units, plan.launches) == (16, 1)
    else:
        assert (plan.units, plan.launches) == (8, 2)
        assert fwd_plan(80, b, 1024, H100_SMS, 1) == plan._replace(
            launches=1)


@pytest.mark.parametrize("b,dirs,ctas,launches", [
    (20, 2, 64, 1), (20, 1, 32, 1), (64, 2, 32, 2), (64, 1, 32, 1)])
def test_lstm_fwd_plans_fit_the_speaker_width(b, dirs, ctas, launches):
    """The speaker's BiLSTMs (H = 256 a direction, T <= 35): both
    directions in one launch of 64 CTAs at selfTrain's 20 rows, one
    launch of 32 CTAs a direction at speaker training's 64."""
    plan = fwd_plan(35, b, 256, H100_SMS, dirs)
    assert (plan.units, plan.ctas, plan.launches) == (8, ctas, launches)
    assert plan.smem == _fwd_smem(35, b, 256, 8) <= _build.MAX_SMEM


@pytest.mark.parametrize("t", [1, 2, 8, 35])
@pytest.mark.parametrize("dirs", [1, 2])
def test_lstm_fwd_plans_fit_the_rescoring_width(t, dirs):
    """The speaker's rescoring of one search path: B = 1, H = 256, T the
    path's moves (1 up to max_action): one launch of 32 CTAs of 8 units
    a direction; the h row keeps its 32 rows."""
    plan = fwd_plan(t, 1, 256, H100_SMS, dirs)
    assert (plan.units, plan.ctas, plan.launches) == (8, 32 * dirs, 1)
    assert plan.smem == _fwd_smem(t, 1, 256, 8) <= _build.MAX_SMEM


@pytest.mark.parametrize("b", [20, 64])
def test_lstm_bwd_plans_fit_the_speaker_width(b):
    """K2 at H = 256: 32 CTAs, 4H = 1024 columns in two chunks of 512,
    both in the ring."""
    plan = bwd_plan(35, b, 256, H100_SMS)
    assert (plan.ctas, plan.kc, plan.nchunks, plan.stages) == (32, 512, 2, 2)
    assert plan.smem == _bwd_smem(35, b, 256, 512, 2) <= _build.MAX_SMEM


def test_misaligned_views_are_copied_before_a_launch():
    """The second direction's mask of the speaker's relabel batch (T 35,
    B 20, bf16) starts 1400 bytes into the stacked mask: the wrappers copy
    it to a 16-byte aligned buffer; an aligned view passes through."""
    import torch

    mask = torch.ones(2, 35, 20, dtype=torch.bfloat16)
    assert mask[1].data_ptr() % 16 != 0
    copied = _build.aligned(mask[1])
    assert copied.data_ptr() % 16 == 0 and torch.equal(copied, mask[1])
    wide = torch.ones(2, 35, 64, dtype=torch.bfloat16)
    assert _build.aligned(wide[1]).data_ptr() == wide[1].data_ptr()


def test_lstm_fwd_sums_go_inside_the_h_row_only_when_they_must():
    """At 64 rows the k groups' partial sums (36 KiB) do not fit beside
    the 128 KiB h row and share it; at 40 rows they sit beside it."""
    row, sums = 64 * 1024 * 2, 4 * 64 * 36 * 4
    apart = fwd_plan(80, 40, 1024, H100_SMS, 2).smem
    shared = fwd_plan(80, 64, 1024, H100_SMS, 2).smem
    assert shared + sums > _build.MAX_SMEM >= shared
    assert shared - apart < row - 48 * 1024 * 2


def test_fwd_pair_limit_uses_the_constants_of_the_cuda_source():
    _text, k1 = _constants("lstm_fwd.cu")
    assert k1["kPairMaxB"] == FWD_PAIR_MAX_B
    assert k1["kMaxSmem"] == _build.MAX_SMEM


def test_fwd_and_shift_plans_use_the_constants_of_the_cuda_sources():
    _text, k1 = _constants("lstm_fwd.cu")
    assert k1["kThreads"] == FWD_THREADS and k1["kPad"] == FWD_PAD
    assert k1["kMaxB"] == FWD_MAX_B
    text = (CSRC / "lstm_fwd.cu").read_text()
    assert re.search(r"U != (\d+) && U != (\d+)", text).groups() == tuple(
        str(u) for u in FWD_UNITS)
    _text, k4 = _constants("shift_attend.cu")
    assert k4["kThreads"] == SHIFT_THREADS and k4["kPad"] == SHIFT_PAD
    assert k4["kMaxNT"] * 8 == SHIFT_MAX_B


@pytest.mark.parametrize("b,ks", [(20, 5), (32, 5), (1, 3), (33, 7)])
def test_shift_headline_plans_fit(b, ks):
    """C = 2176 over 132 SMs: slices of 24 columns, 91 CTAs."""
    plan = shift_plan(b, 36, 2176, 1024, ks, H100_SMS)
    assert (plan.sw, plan.ctas) == (24, 91)
    assert plan.smem == _shift_smem(b, 36, 1024, ks, 24) <= _build.MAX_SMEM


@pytest.mark.parametrize("c,n_sm,sw", [(2176, 132, 24), (1024, 64, 16),
                                       (136, 132, 8), (2048, 128, 16)])
def test_shift_plan_takes_the_narrowest_slice_within_the_sms(c, n_sm, sw):
    plan = shift_plan(20, 36, c, 1024, 5, n_sm)
    assert plan.sw == sw and plan.sw % 8 == 0
    assert plan.ctas == -(-c // sw) <= n_sm
    assert sw == 8 or -(-c // (sw - 8)) > n_sm


@pytest.mark.parametrize("args,match", [
    ((20, 30, 2176, 1024, 5), "multiple of 12"),
    ((20, 72, 2176, 1024, 5), "multiple of 12"),
    ((20, 36, 2176, 1024, 33), "1..32"),
    ((20, 36, 2170, 1024, 5), "multiple of 8"),
    ((20, 36, 2176, 1000, 5), "of 16"),
    ((65, 36, 2176, 1024, 5), "1..64"),
    ((64, 36, 2176, 1024, 5), "shared memory"),
    ((20, 36, 40000, 1024, 5), "more than the 256 weight rows"),
])
def test_shift_plan_refuses_shapes_naming_the_constraint(args, match):
    with pytest.raises(ValueError, match=match):
        shift_plan(*args, H100_SMS)


def test_ndh_rows_chunk_by_the_plans():
    """At NDH's 300 tokens the (T, B) mask leaves room for 48 rows of the
    headline H 1024 BiLSTM (both directions, or one): 64 rows run as two
    chunks of 32, each of which both plans take; 49 rows do not fit one
    launch.  At T 80 / 116 and at the plain encoders' widths 64 rows stay
    one chunk."""
    for dirs in (1, 2):
        assert max_chunk_rows(300, 1024, dirs, H100_SMS) == 48
        assert row_chunks(64, 300, 1024, dirs, H100_SMS) == 2
        assert row_chunks(20, 300, 1024, dirs, H100_SMS) == 1
        assert row_chunks(130, 300, 1024, dirs, H100_SMS) == 3
        for rows in (32, 48):
            fwd_plan(300, rows, 1024, H100_SMS, dirs)
            bwd_plan(300, rows, 1024, H100_SMS)
        with pytest.raises(ValueError, match="shared memory"):
            fwd_plan(300, 49, 1024, H100_SMS, dirs)
    for t_len, hd in ((80, 1024), (116, 1024), (300, 256), (300, 384),
                      (300, 512)):
        assert row_chunks(64, t_len, hd, 2, H100_SMS) == 1
