#!/usr/bin/env python3
"""What torch's CUDA ops compute, to the bit, where the PT shading kernel
(imbatracer_torch/csrc/shading.cuh) must compute the same: on a CUDA
card, each op on random float32 inputs against candidate formulas
evaluated on the host, printed as the share of results equal bit for
bit (1.000000: the op is that formula).

  * torch.sum over a contiguous last dim of 3: (x0 + x1) + x2,
    (x0 + x2) + x1 or x0 + (x1 + x2);
  * torch.linalg.cross: plain a_i * b_j - a_j * b_i, or one of its two
    fused multiply-add forms;
  * a tensor divided by a Python scalar: a multiply by the reciprocal
    taken in float32 or in double, or an IEEE division;
  * torch.reciprocal and `-1.0 / x`: an IEEE division;
  * torch.rsqrt against 1 / sqrt.

Run: `python -m imbatracer_torch.tools.cuda_op_probe` (a few seconds;
torch and numpy only).
"""

import sys

import numpy as np
import torch


def share(a, b):
    """Share of the float32 values of a and b equal bit for bit."""
    a = np.asarray(a, np.float32).view(np.uint32)
    b = np.asarray(b, np.float32).view(np.uint32)
    return float((a == b).mean())


def main():
    if not torch.cuda.is_available():
        raise SystemExit("cuda_op_probe: CUDA is not available")
    dev = torch.device("cuda")
    rs = np.random.RandomState(0)
    f32 = np.float32
    n = 1 << 18

    for what, make in (
            ("x", lambda x, y: x),
            ("x * y", lambda x, y: x * y),
            ("stacked", lambda x, y: torch.stack([x[:, i] for i in range(3)],
                                                 -1))):
        x = (rs.randn(n, 3) * 10.0 ** rs.uniform(-4, 4, (n, 3))).astype(f32)
        y = rs.randn(n, 3).astype(f32)
        t = make(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
        got = torch.sum(t, dim=-1).cpu().numpy()
        a = t.cpu().numpy()
        print(f"sum over 3 of {what}: (x0 + x1) + x2 "
              f"{share(got, (a[:, 0] + a[:, 1]) + a[:, 2]):.6f}, "
              f"(x0 + x2) + x1 {share(got, (a[:, 0] + a[:, 2]) + a[:, 1]):.6f}"
              f", x0 + (x1 + x2) {share(got, a[:, 0] + (a[:, 1] + a[:, 2])):.6f}")

    a, b = rs.randn(n, 3).astype(f32), rs.randn(n, 3).astype(f32)
    got = torch.linalg.cross(torch.from_numpy(a).to(dev),
                             torch.from_numpy(b).to(dev), dim=-1).cpu().numpy()
    wide_a, wide_b = a.astype(np.longdouble), b.astype(np.longdouble)
    for k, (i, j) in enumerate(((1, 2), (2, 0), (0, 1))):
        p1, p2 = a[:, i] * b[:, j], a[:, j] * b[:, i]
        fma1 = (wide_a[:, i] * wide_b[:, j] - p2).astype(f32)
        fma2 = (p1 - wide_a[:, j] * wide_b[:, i]).astype(f32)
        print(f"cross[{k}]: plain {share(got[:, k], p1 - p2):.6f}, "
              f"fma(a{i}, b{j}, -(a{j} * b{i})) {share(got[:, k], fma1):.6f}, "
              f"fma(-a{j}, b{i}, a{i} * b{j}) {share(got[:, k], fma2):.6f}")

    x = rs.uniform(0.01, 100.0, n).astype(f32)
    xt = torch.from_numpy(x).to(dev)
    for scalar in (3, 7, 1e-3, 0.02, 2.0 * np.pi, 1.0 / 7.0):
        got = (xt / scalar).cpu().numpy()
        print(f"x / {scalar!r}: x * (1 / scalar) in float32 "
              f"{share(got, x * (f32(1.0) / f32(scalar))):.6f}, in double "
              f"{share(got, x * f32(1.0 / scalar)):.6f}; IEEE division "
              f"{share(got, x / f32(scalar)):.6f}")
    print(f"reciprocal(x): IEEE 1 / x "
          f"{share(torch.reciprocal(xt).cpu().numpy(), f32(1.0) / x):.6f}")
    print(f"-1.0 / x: IEEE -1 / x "
          f"{share((-1.0 / xt).cpu().numpy(), f32(-1.0) / x):.6f}")
    print(f"rsqrt(x): 1 / sqrt(x) "
          f"{share(torch.rsqrt(xt).cpu().numpy(), f32(1.0) / np.sqrt(x)):.6f}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
