"""Points that stress the folded TTA bilinear gather (`grid_to_point_tta`),
numpy only: used by the CPU tests against JAX and the kernel's arithmetic,
and by the card tests against the plain version.

`coords(rng, B, N, H, W, scale)` gives (B, N, 2) float32 variant-0 coords in
unscaled grid units (row, column), so that after the scale, in order:
uniform over [-2, size + 2]; the rolled RV axes' wrap seams (columns W/2-1
and W/2, fractional and exact); the last row and column; exact integers;
negative positions inside the guard; far outside the grid (+-1e4, where the
clamp moves the window and the guard must zero the row), on either axis
alone and on both. N may be anything from 0 up; the cases fill it in that
order and are cut where N ends.
"""
import numpy as np

FAR = 1e4


def coords(rng, B, N, H, W, scale):
    py = rng.uniform(-2, H + 2, (B, N))
    px = rng.uniform(-2, W + 2, (B, N))
    frac = lambda n: rng.uniform(0.05, 0.95, n)
    iy = lambda n: rng.randint(0, H, n)
    ix = lambda n: rng.randint(0, W, n)
    cases = [  # (rows, columns)
        (iy(8) + frac(8), W // 2 - 1 + frac(8)),
        (iy(8) + frac(8), W // 2 + frac(8)),
        (iy(4) + frac(4), np.array([W // 2 - 1, W // 2, W // 2 + 1,
                                    W // 2 - 2], float)),
        (np.full(4, H - 1.0) + [0, 0.5, 0.99, 0], ix(4) + frac(4)),
        (iy(4) + frac(4), np.full(4, W - 1.0) + [0, 0.5, 0.99, 0]),
        (np.array([H - 1.0, 0.0, H - 1.0, 0.0]),
         np.array([W - 1.0, 0.0, 0.0, W - 1.0])),
        (iy(8).astype(float), ix(8).astype(float)),
        (-frac(4), ix(4) + frac(4)),
        (iy(4) + frac(4), -frac(4)),
        (-1 - frac(4), -1 - frac(4)),
        (np.array([H, H + 0.5, H + 0.99, H]), ix(4) + frac(4)),
        (iy(4) + frac(4), np.array([W, W + 0.5, W + 0.99, W])),
        (np.array([FAR, -FAR, FAR, -FAR]), ix(4) + frac(4)),
        (iy(4) + frac(4), np.array([FAR, -FAR, FAR, -FAR])),
        (np.array([FAR, -FAR, FAR, -FAR]), np.array([FAR, -FAR, -FAR, FAR])),
    ]
    at = 0
    for y, x in cases:
        n = min(len(y), N - at)
        if n <= 0:
            break
        py[:, at:at + n] = y[:n]
        px[:, at:at + n] = x[:n]
        at += n
    return np.stack([py / scale[0], px / scale[1]], -1).astype(np.float32)
