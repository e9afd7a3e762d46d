"""The MAS kernel's plan (vits_tpu_torch/ops/mas.py::plan) and a torch
emulation of its "warp" form on the CPU.

`plan` picks the form the CUDA kernel runs at each shape; the emulation
repeats the warp form's data layout step by step: lane l holds the columns
l * R + r (R = `warp_r(T_x)`), the left neighbour of its first column comes
from lane l - 1, each row's move-left bits go into R words with column
l * R + r at bit l of word r, of which lane r stores word r (the words no
lane stores keep what shared memory held), and the backtrace walks 32 rows
at a time: lane k reads column i0 - k's bit in each row of the window, a
ballot per row gathers them, and the walk runs over those 32 words. It
must be array-equal to `maximum_path_plain` and to the JAX package's
`maximum_path_ref` (the same f32 adds and maxes, so the 0/1 path has no
tolerance)."""

import numpy as np
import pytest
import torch

from vits_tpu.ops import mas as jmas

from vits_tpu_torch.ops import mas

NEG = -1e9


@pytest.mark.parametrize("B,T_y,T_x,form", [
    (16, 400, 96, "warp"),      # chip_smoke.py's shapes: the training step's
    (32, 1000, 384, "warp"),    # the base config's longest utterance and text
    (1, 1000, 1, "warp"),
    (4, 200, 200, "warp"),
    (2, 2000, 384, "warp"),
    (2, 200, 992, "warp"),      # the widest the warp form takes: 32 lanes x 31
    (2, 200, 1000, "block"),    # T_x > 992
    (2, 200, 1024, "block"),
    (2, 1200, 1100, "block"),
    (2, 4000, 512, "block"),    # the bits alone pass shared memory
])
def test_plan_forms(B, T_y, T_x, form):
    p = mas.plan(B, T_y, T_x)
    assert p.form == form
    assert p.smem <= mas.SMEM_LIMIT
    if form == "warp":
        assert p.R in mas.WARP_RS and 32 * p.R >= T_x and p.R % 2 == 1 and p.R <= 31
        assert p.D in mas.WARP_RINGS and p.D % mas.WARP_PARTS == 0 and p.scratch_words == 0
        assert p.smem == 4 * (p.D * -(-T_x // 4) * 4 + 32 * p.R + T_y * p.R)
    else:
        threads = -(-T_x // p.R // 32) * 32
        assert p.D == 0 and threads <= 1024 and p.R * threads >= T_x
        words = -(-T_x // 32)
        # bits in global scratch only at (2, 4000, 512): 4000 x 16 words
        assert p.scratch_words == (T_y * words + T_y if T_x == 512 else 0)


def test_plan_ring_shrinks_before_the_form_changes():
    """The warp form keeps its bits in shared memory: a long utterance takes
    a shallower ring first, then the block form."""
    rings = [mas.plan(1, T_y, 384) for T_y in (1000, 3000, 3800, 4100, 4300)]
    assert [p.D for p in rings] == [64, 32, 16, 8, 0]
    assert [p.form for p in rings] == ["warp"] * 4 + ["block"]


@pytest.mark.parametrize("T_x", [1, 32, 33, 96, 97, 160, 161, 288, 289, 384, 385, 544, 545,
                                 800, 801, 960, 961, 992])
def test_warp_r_is_the_first_odd_width_that_covers(T_x):
    """R columns per lane cover T_x over 32 lanes, R is odd (lane l's ring
    reads on 32 banks) and at most 31 (lane r stores word r), and no
    smaller R of WARP_RS would do."""
    R = mas.warp_r(T_x)
    assert R in mas.WARP_RS and R % 2 == 1 and R <= 31 and 32 * R >= T_x
    smaller = [r for r in mas.WARP_RS if r < R]
    assert not smaller or 32 * smaller[-1] < T_x
    p = mas.plan(1, 100, T_x)
    assert (p.form, p.R) == ("warp", R) and p.smem == mas.warp_smem(100, T_x, R, p.D)


@pytest.mark.parametrize("shape", [(1, 10, 40000), (0, 10, 10), (2, 0, 5), (2, 5, 0)])
def test_plan_raises_where_no_form_fits(shape):
    with pytest.raises(ValueError, match="no kernel form"):
        mas.plan(*shape)


def warp_form(neg: torch.Tensor, t_ys: torch.Tensor, t_xs: torch.Tensor) -> torch.Tensor:
    """The warp form of csrc/mas.cu in torch, lane by lane in layout."""
    B, T_y, T_x = neg.shape
    R = mas.plan(B, T_y, T_x).R
    lanes = torch.arange(32)
    x = lanes[:, None] * R + torch.arange(R)[None, :]           # (32, R): column of lane, r
    neg_l = torch.zeros(B, T_y, 32 * R)
    neg_l[..., :T_x] = neg.float()
    neg_l = neg_l.view(B, T_y, 32, R)
    t_y = t_ys.long().clamp(0, T_y)[:, None, None]
    t_x = t_xs.long().clamp(0, T_x)[:, None, None]
    v = torch.full((B, 32, R), NEG)
    # word r, bit l: column l R + r; shared memory starts with arbitrary bits,
    # and a row's word r lands only where lane r keeps it
    words = torch.randint(0, 2 ** 32, (B, T_y, R), generator=torch.Generator().manual_seed(R))
    stored = torch.arange(R) < 32
    for y in range(T_y):
        up = torch.cat([torch.full((B, 1), 0.0 if y == 0 else NEG), v[:, :-1, R - 1]], 1)
        left = torch.cat([up[..., None], v[..., :-1]], -1)      # shfl_up of the last column
        feas = (x <= y) & (x >= t_x - t_y + y) & (x < t_x) & (y < t_y)
        nv = torch.where(feas, neg_l[:, y] + torch.maximum(v, left), torch.full_like(v, NEG))
        move = (x == y) | (v < left)          # column 0's bit is never read
        ballots = (move.long() << lanes[None, :, None]).sum(1)      # R ballots
        words[:, y] = torch.where(stored, ballots, words[:, y])
        v = nv
    path = torch.zeros(B, T_y, T_x)
    for b in range(B):
        ty, i0 = int(t_y[b]), max(int(t_x[b]) - 1, 0)
        for y0 in range(ty - 1, -1, -32):
            masks = []
            for j in range(32):                                # one ballot per row y0 - j
                y, m = y0 - j, 0
                for k in range(32):                            # lane k: column i0 - k
                    c = i0 - k
                    if c > 0 and y > 0:
                        m |= ((int(words[b, y, c % R]) >> (c // R)) & 1) << k
                masks.append(m)
            off = 0
            for j in range(32):                                # the walk, in registers
                if y0 - j >= 0:
                    path[b, y0 - j, i0 - off] = 1.0
                off += (masks[j] >> off) & 1
            i0 -= off
    return path


def _case(rng, B, T_y, T_x, t_ys, t_xs):
    neg = (rng.randn(B, T_y, T_x) * 10).astype(np.float32)
    return neg, np.asarray(t_ys, np.int32), np.asarray(t_xs, np.int32)


CASES = {
    "ragged": (4, 70, 45, [70, 61, 33, 9], [45, 40, 20, 9]),   # T_x not a multiple of 32
    "ragged_long": (2, 150, 70, [150, 97], [70, 3]),          # R = 3, several 32-row windows
    "diagonal": (3, 37, 37, [37, 20, 1], [37, 20, 1]),        # t_x == t_y
    "one_token": (2, 50, 1, [50, 7], [1, 1]),                  # t_x = 1
    "one_frame": (2, 1, 8, [1, 1], [1, 1]),                   # t_y = 1
    "wide": (2, 40, 100, [40, 36], [33, 36]),                 # a row over 4 lanes' words
    "rounded_up": (2, 40, 300, [40, 33], [40, 31]),           # R 13 for 10 columns a lane
    "widest": (1, 33, 992, [33], [20]),                       # R 31, the last lane full
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_warp_form_equals_plain_and_ref(case):
    B, T_y, T_x, t_ys, t_xs = CASES[case]
    rng = np.random.RandomState(T_y + T_x)
    neg, t_ys, t_xs = _case(rng, B, T_y, T_x, t_ys, t_xs)
    mask = ((np.arange(T_y)[None, :, None] < t_ys[:, None, None])
            & (np.arange(T_x)[None, None, :] < t_xs[:, None, None]))
    neg = neg * mask                       # maximum_path's neg_cent * mask
    args = (torch.from_numpy(neg), torch.from_numpy(t_ys), torch.from_numpy(t_xs))
    got = warp_form(*args).numpy()
    np.testing.assert_array_equal(got, mas.maximum_path_plain(*args).numpy())
    np.testing.assert_array_equal(got, jmas.maximum_path_ref(neg, t_ys, t_xs))
    np.testing.assert_array_equal(got.sum(axis=(1, 2)), t_ys)


def test_warp_form_zero_lengths_equal_plain():
    """An empty utterance (t_y = t_x = 0) keeps an all-zero path; t_x = 0 with
    frames left puts them on column 0, as the plain version does."""
    rng = np.random.RandomState(5)
    neg, t_ys, t_xs = _case(rng, 3, 20, 9, [0, 20, 6], [0, 9, 0])
    args = (torch.from_numpy(neg), torch.from_numpy(t_ys), torch.from_numpy(t_xs))
    got = warp_form(*args)
    assert torch.equal(got, mas.maximum_path_plain(*args))
    assert got[0].sum() == 0 and got[2, :6, 0].sum() == 6
