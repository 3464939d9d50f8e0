"""TV-L1 optical flow on the device of its input (the reference's flow branch).

The port's own copy of the JAX package's ``data/optical_flow.py``.  The
reference computes dense optical flow between consecutive resized gray
frames with OpenCV's DualTVL1, clips it to +-20 px, scales by /20 and
center-crops (utils/pre_process_rgb_flow.py:104-124).  That branch is dead
on every attack path (``flow=False`` throughout), but a user of the
reference finds it in the API, so it is rebuilt here.

The algorithm is the duality-based TV-L1 of Zach, Pock & Bischof (DAGM 2007)
as OpenCV implements it (Sanchez et al., "TV-L1 Optical Flow Estimation",
IPOL 2013): a coarse-to-fine pyramid; per scale, ``warps`` relinearizations
of the data term around the current flow; per warp, a fixed number of
primal-dual iterations alternating

    v   <- u + TH(rho(u), grad I1w)          (pointwise data-term proximal)
    u_d <- v_d + theta * div(p_d)            (primal update, d in {x, y})
    p_d <- (p_d + tau/theta * grad u_d) / (1 + tau/theta * |grad u_d|)

The JAX solver's deviations from OpenCV are kept: fixed-trip iterations
with no epsilon early exit, pyramid zoom 0.5 with a floor of 16 px on the
short side, no median filter between warps.

Every function takes a leading batch of pairs: the stencils work on dims
-2/-1, and ``flow_for_video`` solves a clip's T-1 pairs as one batch (the
counterpart of the JAX ``vmap``).  The solver is plain PyTorch on the
device of its input; the JAX package has no Pallas kernel here.  Two pieces
follow the JAX arithmetic rather than a PyTorch library call:

* ``_warp`` is ``map_coordinates(order=1, mode="nearest")`` written as an
  explicit gather (floor, both neighbours clamped to [0, size-1], the four
  corners summed with dim 0 outer and weight ``wy*wx``), not
  ``F.grid_sample``, whose coordinate normalisation rounds differently;
* the pyramid's resize is ``jax.image.resize(..., "linear")`` (antialiased):
  two f32 contractions, H then W, with the weight matrices
  ``jax.image.scale_and_translate`` builds.  On CUDA the contraction must not
  run in TF32 (``torch.backends.cuda.matmul.allow_tf32`` off, PyTorch's
  default), else ``tvl1_flow`` raises.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

# OpenCV DualTVL1OpticalFlow defaults (tau, lambda, theta, nscales, warps)
TAU = 0.25
LAMBDA = 0.15
THETA = 0.3
NSCALES = 5
WARPS = 5
ITERATIONS = 30  # primal-dual iterations per warp
_GRAD_EPS = 1e-9


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a*b + c in f32 rounded once, as XLA fuses a product into a sum: the
    f32 product is exact in f64."""
    return torch.addcmul(c.double(), a.double(), b.double()).float()


def _forward_diff(u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward differences with Neumann boundary (last row/col -> 0)."""
    ux = torch.zeros_like(u)
    uy = torch.zeros_like(u)
    ux[..., :, :-1] = u[..., :, 1:] - u[..., :, :-1]
    uy[..., :-1, :] = u[..., 1:, :] - u[..., :-1, :]
    return ux, uy


def _divergence(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Adjoint of -_forward_diff: backward differences, matching boundary."""
    h, w = p1.shape[-2:]
    d1 = p1.clone()
    d1[..., :, 1:] -= p1[..., :, :-1]
    if w > 1:
        d1[..., :, w - 1] = -p1[..., :, w - 2]
    d2 = p2.clone()
    d2[..., 1:, :] -= p2[..., :-1, :]
    if h > 1:
        d2[..., h - 1, :] = -p2[..., h - 2, :]
    return d1 + d2


def _centered_grad(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Centered differences, one-sided at the borders."""
    gx = (torch.roll(img, -1, -1) - torch.roll(img, 1, -1)) * 0.5
    gx[..., :, 0] = img[..., :, 1] - img[..., :, 0]
    gx[..., :, -1] = img[..., :, -1] - img[..., :, -2]
    gy = (torch.roll(img, -1, -2) - torch.roll(img, 1, -2)) * 0.5
    gy[..., 0, :] = img[..., 1, :] - img[..., 0, :]
    gy[..., -1, :] = img[..., -1, :] - img[..., -2, :]
    return gx, gy


def _warp(img: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of img [..., H, W] at (x + u1, y + u2), border-clamped
    (``map_coordinates(order=1, mode="nearest")``)."""
    h, w = img.shape[-2:]
    yy = torch.arange(h, dtype=img.dtype, device=img.device)[:, None]
    xx = torch.arange(w, dtype=img.dtype, device=img.device)[None, :]
    cy, cx = yy + u2, xx + u1
    fy, fx = torch.floor(cy), torch.floor(cx)
    wy1, wx1 = cy - fy, cx - fx
    wy0, wx0 = 1 - wy1, 1 - wx1
    iy, ix = fy.to(torch.int64), fx.to(torch.int64)
    rows = (iy.clamp(0, h - 1), (iy + 1).clamp(0, h - 1))
    cols = (ix.clamp(0, w - 1), (ix + 1).clamp(0, w - 1))
    flat = img.reshape(img.shape[:-2] + (h * w,))
    out = None
    for r, wy in zip(rows, (wy0, wy1)):
        for c, wx in zip(cols, (wx0, wx1)):
            idx = (r * w + c).reshape(flat.shape)
            value = torch.gather(flat, -1, idx).reshape(img.shape)
            out = (wy * wx) * value if out is None else _fma(wy * wx, value, out)
    return out


@lru_cache(maxsize=None)
def _weight_mat(in_size: int, out_size: int) -> np.ndarray:
    """[in, out] f32 weights of ``jax.image.scale_and_translate``'s linear
    (triangle) kernel, antialiased: scaled by 1/scale on a downsample, each
    column normalised by its sum, columns whose sample lies outside
    [-0.5, in-0.5] zeroed."""
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = np.float32(max(inv_scale, 1.0))
    sample_f = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * np.float32(
        inv_scale) - np.float32(0.0) - np.float32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    weights = np.maximum(np.float32(0), np.float32(1) - np.abs(x))
    total = np.zeros((1, out_size), np.float32)
    for row in weights:  # the reduction in input order
        total = total + row
    ok = np.abs(total) > np.float32(1000.0 * np.finfo(np.float32).eps)
    weights = np.where(ok, weights / np.where(total != 0, total, np.float32(1)), np.float32(0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, np.float32(0)).astype(np.float32)


def _resize(x: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(x, shape, "linear")`` on dims -2/-1 of x (f32):
    the H contraction, then the W one; an axis whose size is kept is not
    touched."""
    h, w = x.shape[-2:]
    nh, nw = shape
    if nh != h:
        wh = torch.from_numpy(_weight_mat(h, nh)).to(x.device)
        x = torch.matmul(wh.t(), x)
    if nw != w:
        ww = torch.from_numpy(_weight_mat(w, nw)).to(x.device)
        x = torch.matmul(x, ww)
    return x


def _tvl1_scale(i0, i1, u1, u2, tau, lam, theta, warps: int, iterations: int):
    """Run `warps` relinearizations at one pyramid scale; tau, lam, theta
    0-d f32 tensors."""
    i1x, i1y = _centered_grad(i1)
    l_t = lam * theta
    taut = tau / theta
    p11 = torch.zeros_like(u1)
    p12 = torch.zeros_like(u1)
    p21 = torch.zeros_like(u1)
    p22 = torch.zeros_like(u1)
    for _ in range(warps):
        u1_0, u2_0 = u1, u2  # linearization point
        i1w = _warp(i1, u1_0, u2_0)
        i1wx = _warp(i1x, u1_0, u2_0)
        i1wy = _warp(i1y, u1_0, u2_0)
        grad2 = i1wx * i1wx + i1wy * i1wy + _GRAD_EPS
        # rho(u) = I1w + <grad I1w, u - u0> - I0, affine in u
        rho_c = i1w - i1wx * u1_0 - i1wy * u2_0 - i0
        lo, hi = -l_t * grad2, l_t * grad2
        for _ in range(iterations):
            rho = rho_c + i1wx * u1 + i1wy * u2
            # pointwise proximal of the L1 data term (IPOL eq. 14)
            below, above = rho < lo, rho > hi
            d1 = torch.where(below, l_t * i1wx,
                             torch.where(above, -l_t * i1wx, -rho * i1wx / grad2))
            d2 = torch.where(below, l_t * i1wy,
                             torch.where(above, -l_t * i1wy, -rho * i1wy / grad2))
            v1 = u1 + d1
            v2 = u2 + d2
            u1 = v1 + theta * _divergence(p11, p12)
            u2 = v2 + theta * _divergence(p21, p22)
            u1x, u1y = _forward_diff(u1)
            u2x, u2y = _forward_diff(u2)
            ng1 = 1.0 + taut * torch.sqrt(u1x * u1x + u1y * u1y)
            ng2 = 1.0 + taut * torch.sqrt(u2x * u2x + u2y * u2y)
            p11 = (p11 + taut * u1x) / ng1
            p12 = (p12 + taut * u1y) / ng1
            p21 = (p21 + taut * u2x) / ng2
            p22 = (p22 + taut * u2y) / ng2
    return u1, u2


def _pyramid_shapes(h: int, w: int, nscales: int):
    """Static per-scale shapes, zoom 0.5, floor 16 px on the short side."""
    shapes = [(h, w)]
    for _ in range(1, nscales):
        nh, nw = shapes[-1][0] // 2, shapes[-1][1] // 2
        if min(nh, nw) < 16:
            break
        shapes.append((nh, nw))
    return shapes


def tvl1_flow(
    i0: torch.Tensor,
    i1: torch.Tensor,
    tau: float = TAU,
    lam: float = LAMBDA,
    theta: float = THETA,
    nscales: int = NSCALES,
    warps: int = WARPS,
    iterations: int = ITERATIONS,
) -> torch.Tensor:
    """Dense TV-L1 flow from gray images i0 to i1 [..., H, W] (a leading
    batch of pairs, or none); returns [..., H, W, 2] (dx, dy) f32 on their
    device.

    Inputs are expected on the 0..255 gray scale (uint8 or float): the
    default `lam` is calibrated for that scale and the values are only cast,
    never rescaled.
    """
    i0 = torch.as_tensor(i0).float()
    i1 = torch.as_tensor(i1).float().to(i0.device)
    if i0.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "tvl1_flow's pyramid contracts in f32: set torch.backends.cuda.matmul.allow_tf32 "
            "= False")
    f32 = dict(dtype=torch.float32, device=i0.device)
    tau_t, lam_t, theta_t = (torch.tensor(v, **f32) for v in (tau, lam, theta))
    h, w = i0.shape[-2:]
    shapes = _pyramid_shapes(h, w, nscales)

    pyr0 = [i0]
    pyr1 = [i1]
    for sh in shapes[1:]:
        pyr0.append(_resize(pyr0[-1], sh))
        pyr1.append(_resize(pyr1[-1], sh))

    u1 = torch.zeros(i0.shape[:-2] + shapes[-1], **f32)
    u2 = torch.zeros_like(u1)
    for s in range(len(shapes) - 1, -1, -1):
        u1, u2 = _tvl1_scale(pyr0[s], pyr1[s], u1, u2, tau_t, lam_t, theta_t, warps, iterations)
        if s > 0:
            up = shapes[s - 1]
            # flow values are in pixels: scale by the zoom factor on upsample
            fy = np.float32(up[0] / shapes[s][0])
            fx = np.float32(up[1] / shapes[s][1])
            u1 = _resize(u1, up) * float(fx)
            u2 = _resize(u2, up) * float(fy)
    return torch.stack([u1, u2], dim=-1)


def rgb_to_gray(frames: torch.Tensor) -> torch.Tensor:
    """ITU-R BT.601 luma, the cv2.COLOR_RGB2GRAY weighting ([..., H, W, 3])."""
    coeffs = [torch.tensor(c, dtype=frames.dtype, device=frames.device)
              for c in (0.299, 0.587, 0.114)]
    gray = frames[..., 0] * coeffs[0]
    for k in (1, 2):  # the dot's products fused into its running sum
        gray = _fma(frames[..., k], coeffs[k], gray).to(frames.dtype)
    return gray


def flow_for_video(
    gray: torch.Tensor,
    warps: int = WARPS,
    iterations: int = ITERATIONS,
    nscales: int = NSCALES,
) -> torch.Tensor:
    """Flow for each consecutive pair of a gray clip [T, H, W] -> [T-1, H, W, 2],
    on the clip's device.  The T-1 pairs are solved as one batch."""
    gray = torch.as_tensor(gray)
    return tvl1_flow(gray[:-1], gray[1:], warps=warps, iterations=iterations, nscales=nscales)


def postprocess_flow(flow: torch.Tensor, crop_size: int = 224) -> torch.Tensor:
    """The reference's flow normalization: clip +-20 px, /20, center-crop
    (pre_process_rgb_flow.py:110-114)."""
    flow = torch.clamp(flow, -20.0, 20.0) / 20.0
    h, w = flow.shape[-3], flow.shape[-2]
    y1 = (h - crop_size) // 2
    x1 = (w - crop_size) // 2
    return flow[..., y1 : y1 + crop_size, x1 : x1 + crop_size, :]
