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
  * torch.rsqrt against 1 / sqrt;
  * the VCM kernels' (csrc/vcm_shade.cu): `floor(x).to(torch.int32)` on
    values in and out of int32's range, NaN and infinities included,
    against a saturating cast (NaN -> 0) and x86's INT_MIN for anything
    out of range; torch.minimum of int32 tensors; a tensor and a 0-d
    tensor divided by a Python int (the light-path count and the
    connections' normaliser); the light pick `(path_id * num_lights) //
    light_path_count` in int32, against a wrapping product and a
    flooring division;
  * the photon grid's (csrc/grid_build.cu): a float32 tensor times and
    minus a Python float (1.01, 1e-6), against the float taken as a
    float32 operand and the operation in double; `(b.double() -
    e.double() * eps).float()` against two double operations and one
    rounding; `1.0 / x` against an IEEE division.

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
    probe_vcm(dev, rs)
    probe_grid(dev, rs)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}")
    return 0


def probe_vcm(dev, rs):
    """The ops whose CUDA results csrc/vcm_shade.cu mimics."""
    f32 = np.float32
    n = 1 << 16
    x = np.concatenate([
        rs.uniform(-4e3, 4e3, n), rs.uniform(-3e9, 3e9, n),
        rs.choice([2.0**31, -2.0**31, 2.0**31 - 128, -2.0**31 - 256, 1e10,
                   -1e10, 1e30, -1e30, np.inf, -np.inf, np.nan], n)]).astype(f32)
    got = torch.floor(torch.from_numpy(x).to(dev)).to(torch.int32).cpu().numpy()
    fl = np.floor(x.astype(np.float64))
    sat = np.where(np.isnan(fl), 0, np.clip(np.nan_to_num(fl, posinf=2**31,
                                                          neginf=-2**31),
                                            -2**31, 2**31 - 1)).astype(np.int64)
    inside = (fl >= -2**31) & (fl <= 2**31 - 1)
    x86 = np.where(inside, np.nan_to_num(fl), -2**31).astype(np.int64)
    print(f"floor(x).to(int32): saturating (NaN -> 0) "
          f"{float((got == sat).mean()):.6f}, INT_MIN out of range "
          f"{float((got == x86).mean()):.6f}; in range "
          f"{float((got == sat)[inside].mean()):.6f}")
    a = rs.randint(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    b = rs.randint(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    got = torch.minimum(torch.from_numpy(a).to(dev),
                        torch.from_numpy(b).to(dev)).cpu().numpy()
    print(f"minimum int32: np.minimum {float((got == np.minimum(a, b)).mean()):.6f}")
    y = rs.uniform(0.0, 4.0e6, n).astype(f32)
    yt = torch.from_numpy(y).to(dev)
    for d in (192, 1 << 18, 1 << 20, 3 * (1 << 20), 8 * 1000003):
        got = (yt / d).cpu().numpy()
        print(f"x / {d}: x * (1 / d) in double {share(got, y * f32(1.0 / d)):.6f}"
              f", in float32 {share(got, y * (f32(1.0) / f32(d))):.6f}; IEEE "
              f"{share(got, y / f32(d)):.6f}")
        zd = [torch.tensor(float(v), device=dev) / d for v in y[:64]]
        got = np.array([float(t) for t in zd], f32)
        print(f"0-d x / {d}: x * (1 / d) in double "
              f"{share(got, y[:64] * f32(1.0 / d)):.6f}; IEEE "
              f"{share(got, y[:64] / f32(d)):.6f}")
    pid = np.concatenate([np.arange(0, 1 << 20, 97), rs.randint(
        -2**31, 2**31, 4096, dtype=np.int64)]).astype(np.int32)
    for lights, lpc in ((3, 1 << 20), (7, 200003), (1000, 1 << 18)):
        got = ((torch.from_numpy(pid).to(dev) * lights) // lpc).cpu().numpy()
        prod = (pid.astype(np.int64) * lights).astype(np.int32)   # wraps
        want = np.floor_divide(prod.astype(np.int64), lpc)
        print(f"light pick (path_id * {lights}) // {lpc} in int32: wrapping "
              f"product, flooring division {float((got == want).mean()):.6f}")



def probe_grid(dev, rs):
    """The ops whose CUDA results csrc/grid_build.cu mimics."""
    f32 = np.float32
    n = 1 << 16
    x = (rs.randn(n) * 10.0 ** rs.uniform(-3, 3, n)).astype(f32)
    xt = torch.from_numpy(x).to(dev)
    wide = x.astype(np.float64)
    for what, got, want in (
            ("x * 1.01", xt * 1.01, (x * f32(1.01), wide * 1.01)),
            ("x - 1e-6", xt - 1e-6, (x - f32(1e-6), wide - 1e-6))):
        got = got.cpu().numpy()
        print(f"{what}: the Python float as a float32 operand "
              f"{share(got, want[0]):.6f}, in double "
              f"{share(got, want[1].astype(f32)):.6f}")
    e = np.abs(rs.randn(n) * 10.0 ** rs.uniform(-3, 3, n)).astype(f32)
    eps = torch.tensor(1e-3, dtype=torch.float32).item()
    got = (xt.double() - torch.from_numpy(e).to(dev).double() * eps).float()
    want = (wide - e.astype(np.float64) * eps).astype(f32)
    print(f"(b.double() - e.double() * eps).float(): two double operations "
          f"and one rounding {share(got.cpu().numpy(), want):.6f}")
    y = np.abs(x) + f32(1e-6)
    got = (1.0 / torch.from_numpy(y).to(dev)).cpu().numpy()
    print(f"1.0 / x: IEEE 1 / x {share(got, f32(1.0) / y):.6f}")


if __name__ == "__main__":
    sys.exit(main())
