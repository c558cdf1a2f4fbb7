"""The port's unfolded `grid_to_point` on a bfloat16 grid forms its sampling
positions in float32: at coordinates in [256, 512) of a grid 512 wide it
matches the JAX package's float32 reference `grid_to_point_ref` at the
float32 positions, to the bfloat16 rounding of the values. Rounding the coordinates to bfloat16 first (as the
JAX op does: a spacing of 2 cells there) lands up to a cell away, and the
same comparison tells that apart.

Tolerance: the tap weights and the four products and sums are rounded to
bfloat16 (8 significant bits), so each output lies within a few units in
the last place of the largest tap value: 4 x 2^-8 of max |grid|.
"""
import numpy as np
import torch

from streammos_tpu.ops import grid_to_point_ref
from streammos_tpu_torch.ops.sample import grid_to_point

SCALE = (1.0, 1.0)


def _case():
    rng = np.random.RandomState(17)
    grid = torch.from_numpy(rng.randn(2, 4, 512, 8).astype(np.float32)
                            ).to(torch.bfloat16)
    rows = rng.uniform(0.0, 3.0, (2, 300))
    cols = rng.uniform(256.0, 512.0, (2, 300))
    coords = np.stack([rows, cols], axis=-1).astype(np.float32)
    return grid, coords


def test_bf16_grid_samples_at_float32_positions():
    grid, coords = _case()
    values = grid.float().numpy()
    got = grid_to_point(grid, torch.from_numpy(coords), SCALE)
    assert got.dtype == torch.bfloat16
    want = grid_to_point_ref(values, coords, SCALE)
    tol = 4 * 2.0 ** -8 * np.abs(values).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)

    # positions rounded to the grid's dtype first: far outside that bound
    rounded = torch.from_numpy(coords).to(torch.bfloat16).float().numpy()
    moved = grid_to_point_ref(values, rounded, SCALE)
    assert np.abs(moved - want).max() > 10 * tol
