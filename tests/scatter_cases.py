"""Cell-id distributions that stress the scatter-max kernels, numpy only
(shared by `tests/test_torch_scatter.py`, against JAX on the CPU,
`tests/test_torch_scatter_tta.py`, and `tests/test_torch_cuda.py`, on the
card, which imports no jax).

Each case is (ids, n_cells): int32 ids in [0, n_cells] (n_cells is the
sentinel of invalid points), unsorted, with the last cell empty where the
case has room for it.
"""
import numpy as np

KINDS = ("one_cell", "one_per_row", "runs_64", "runs_128", "runs_256",
         "gap", "sentinel")
# the cases a grid of JAX's `fits_vmem` can hold (the gap needs 10^5 cells)
VMEM_KINDS = tuple(k for k in KINDS if k != "gap")
GAP = 100_001  # empty cells between the two occupied stretches of "gap"


def scatter_case(kind: str, rng: np.random.Generator, P: int):
    """ids (P,) int32 and n_cells for one kind:
    - one_cell: every row in one cell;
    - one_per_row: a cell a row;
    - runs_B: runs of exactly B rows in consecutive cells, so runs end at
      every multiple of B rows;
    - gap: half the rows in the first 50 cells, half in 50 cells more than
      10^5 empty cells further on;
    - sentinel: every row invalid."""
    if kind == "one_cell":
        ids, n_cells = np.full(P, 2), 5
    elif kind == "one_per_row":
        ids, n_cells = np.arange(P), P + 1
    elif kind.startswith("runs_"):
        b = int(kind[5:])
        ids = np.arange(P) // b
        n_cells = int(ids[-1]) + 2 if P else 2
    elif kind == "gap":
        ids = rng.integers(0, 50, P)
        far = rng.uniform(size=P) < 0.5
        ids[far] += 50 + GAP
        n_cells = 100 + GAP + 1
    elif kind == "sentinel":
        n_cells = 64
        ids = np.full(P, n_cells)
    else:
        raise ValueError(f"unknown kind {kind!r}")
    return rng.permutation(ids).astype(np.int32), n_cells


def scatter_rows(rng: np.random.Generator, ids: np.ndarray, C: int,
                 signed: bool) -> np.ndarray:
    """(P, C) float32 rows that bfloat16 holds exactly (8 significant
    bits). signed: the rows of every even cell are negative, so those cells
    have negative maxima on both sides of every run boundary; else every
    value is >= 0."""
    x = np.minimum(np.abs(rng.normal(size=(len(ids), C))), 3.9)
    x = np.ldexp(np.round(np.ldexp(x, 6)), -6).astype(np.float32)
    if signed:
        x[ids % 2 == 0] *= -1
        x[ids % 2 == 0] -= 1 / 64
    return x


def sort_by_id(ids: np.ndarray, rows: np.ndarray):
    """The rows in ascending id order, as `scatter_max_pallas` sorts them."""
    order = np.argsort(ids, kind="stable")
    return ids[order], rows[order]


def case_coords(ids: np.ndarray, n_cells: int, W: int, scale):
    """float32 (P, 2) coordinates of cell ids on a grid W cells wide, at
    each cell's centre, the sentinel id one row below the grid, and the
    grid's (even) number of rows H: (coords, H)."""
    r, q = np.divmod(ids.astype(np.int64), W)
    H = -(-n_cells // W)
    H += H % 2
    r = np.where(ids == n_cells, H, r)
    c = np.stack([(r + 0.5) / scale[0], (q + 0.5) / scale[1]], -1)
    return c.astype(np.float32), H
