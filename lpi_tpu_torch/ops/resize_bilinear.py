"""Half-pixel bilinear upsample of NHWC maps: CUDA kernels and their plain
versions.

`resize_bilinear(x, H, W)` is `jax.image.resize(x, (B, H, W, C),
"bilinear")` for an upsample (H >= h, W >= w): half-pixel centres, no
antialias, which is `F.interpolate(mode="bilinear", align_corners=False)`.
A downsample is refused, because there `jax.image.resize` antialiases and
`F.interpolate` does not. Along an axis of `in` inputs and `out` outputs,
output j reads inputs i0 and i1:

    scale = in / out (fp32), src = max(scale * (j + 0.5) - 0.5, 0),
    i0 = floor(src), i1 = min(i0 + 1, in - 1), l1 = src - i0, l0 = 1 - l1

* CPU tensors take `resize_bilinear_reference`, `F.interpolate`, with its
  own autograd;
* CUDA tensors (fp32 or bf16) take the kernels of
  `lpi_tpu_torch/csrc/resize_bilinear.cu` (design and bound in its header
  note) through `_ResizeBilinear`: `resize_bilinear_forward` and
  `resize_bilinear_backward`, each with its own launch counter. The
  backward gathers: one thread a channel group of an input pixel sums, in a
  fixed order, the outputs that read it, so it needs no atomics, no sort
  and no zero fill, and two calls give equal bits under deterministic
  algorithms or not.

`resize_bilinear_backward_reference` is the backward's gather form in plain
torch: the index ranges and weights the backward kernel walks.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from lpi_tpu_torch.ops import cuda_build


def _check(x, H: int, W: int):
    if x.dim() != 4:
        raise ValueError(f"resize_bilinear takes an NHWC map, got shape {tuple(x.shape)}")
    _check_sizes(x.shape[1], x.shape[2], H, W)


def _check_sizes(h: int, w: int, H: int, W: int):
    if H < h or W < w:
        raise ValueError(f"resize_bilinear upsamples only: ({h}, {w}) -> ({H}, {W}); "
                         "jax.image.resize antialiases a downsample")


def resize_bilinear_reference(x, H: int, W: int) -> torch.Tensor:
    """Plain version: `F.interpolate` on the NCHW view, NHWC out."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(H, W), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


def _axis_taps(n_in: int, n_out: int, dtype: torch.dtype):
    """(i0, i1, l0, l1) of every output index along one axis, operation by
    operation as the kernels compute them, in PyTorch's accumulation type
    for `dtype` (fp64 for fp64, else fp32: the kernels' own)."""
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    scale = torch.tensor(n_in, dtype=acc) / n_out
    src = ((torch.arange(n_out, dtype=acc) + 0.5) * scale - 0.5).clamp(min=0.0)
    i0 = src.to(torch.int64).clamp(max=n_in - 1)
    i1 = (i0 + 1).clamp(max=n_in - 1)
    l1 = src - i0
    return i0, i1, 1.0 - l1, l1


def _axis_gather(n_in: int, n_out: int, dtype: torch.dtype):
    """For each input index i along one axis, the output indices that read
    it, [n_in, n] (the range where i0 is i - 1 or i, ascending, padded with
    weight 0), and their weights [n_in, n]."""
    i0, i1, l0, l1 = _axis_taps(n_in, n_out, dtype)
    i = torch.arange(n_in)
    lo = torch.searchsorted(i0, i - 1)
    hi = torch.searchsorted(i0, i + 1)
    j = lo[:, None] + torch.arange(int((hi - lo).max()))
    inside = j < hi[:, None]
    j = j.clamp(max=n_out - 1)
    w = (torch.where(i0[j] == i[:, None], l0[j], 0.0)
         + torch.where(i1[j] == i[:, None], l1[j], 0.0))
    return j, torch.where(inside, w, 0.0)


def resize_bilinear_backward_reference(ct, h: int, w: int) -> torch.Tensor:
    """Plain gather-form backward: ct [B, H, W, C] -> d x [B, h, w, C] in
    ct's dtype, each input pixel summing w_y * w_x * ct over the outputs
    that read it. In fp64 the taps are fp64, as `F.interpolate`'s are."""
    jy, wy = _axis_gather(h, ct.shape[1], ct.dtype)
    jx, wx = _axis_gather(w, ct.shape[2], ct.dtype)
    jy, wy, jx, wx = (t.to(ct.device) for t in (jy, wy, jx, wx))
    rows = ct[:, jy][:, :, :, jx]  # [B, h, ny, w, nx, C]
    weights = (wy[:, :, None, None] * wx[None, None]).to(ct.dtype)  # [h, ny, w, nx]
    return torch.einsum("bpqrsc,pqrs->bprc", rows, weights)


@functools.cache
def _entry(name: str):
    """The kernel library's C entry point `lpi_resize_bilinear_{fwd,bwd}`,
    built and typed at first use."""
    fn = getattr(cuda_build.load("resize_bilinear"), name)
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, src, dst, B, h, w, H, W, C):
    if src.device.type != "cuda":
        raise ValueError(f"{name} runs on the card, got a tensor on {src.device}")
    if src.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"resize_bilinear takes float32 or bfloat16 on the card, got {src.dtype}")
    lanes = 16 // src.element_size()
    vec = lanes if C % lanes == 0 and src.data_ptr() % 16 == 0 else 1
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry(name)(src.data_ptr(), dst.data_ptr(), B, h, w, H, W, C,
                           int(src.dtype == torch.bfloat16), vec, stream)
    if err != 0:
        raise RuntimeError(f"{name} failed to launch: CUDA error {err}")


def resize_bilinear_forward(x, H: int, W: int) -> torch.Tensor:
    """The forward kernel: x [B, h, w, C] on the card -> [B, H, W, C] in
    x's dtype. `resize_bilinear_forward.launches` counts kernel launches."""
    _check(x, H, W)
    x = x.contiguous()
    B, h, w, C = x.shape
    y = torch.empty((B, H, W, C), dtype=x.dtype, device=x.device)
    _launch("lpi_resize_bilinear_fwd", x, y, B, h, w, H, W, C)
    resize_bilinear_forward.launches += 1
    return y


def resize_bilinear_backward(ct, h: int, w: int) -> torch.Tensor:
    """The backward kernel: ct [B, H, W, C] on the card -> d x [B, h, w, C]
    in ct's dtype. `resize_bilinear_backward.launches` counts kernel
    launches."""
    B, H, W, C = ct.shape
    _check_sizes(h, w, H, W)
    ct = ct.contiguous()  # autograd may hand over a strided cotangent
    dx = torch.empty((B, h, w, C), dtype=ct.dtype, device=ct.device)
    _launch("lpi_resize_bilinear_bwd", ct, dx, B, h, w, H, W, C)
    resize_bilinear_backward.launches += 1
    return dx


class _ResizeBilinear(torch.autograd.Function):
    """Forward and backward through the kernels (CUDA tensors only)."""

    @staticmethod
    def forward(ctx, x, H, W):
        ctx.in_size = x.shape[1:3]
        return resize_bilinear_forward(x, H, W)

    @staticmethod
    def backward(ctx, ct):
        return resize_bilinear_backward(ct, *ctx.in_size), None, None


def resize_bilinear(x, H: int, W: int) -> torch.Tensor:
    """Differentiable half-pixel bilinear upsample of an NHWC map x [B, h,
    w, C] to [B, H, W, C]: the plain version for CPU tensors, the kernels
    for CUDA tensors."""
    _check(x, H, W)
    if x.device.type == "cpu":
        return resize_bilinear_reference(x, H, W)
    if x.device.type != "cuda":
        raise ValueError(f"no resize_bilinear kernel for device {x.device}")
    return _ResizeBilinear.apply(x, H, W)


def reset_launch_counts() -> None:
    resize_bilinear_forward.launches = resize_bilinear_backward.launches = 0


reset_launch_counts()
