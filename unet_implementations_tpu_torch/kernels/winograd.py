"""K4: Winograd F(2x2, 3x3) convolution on q-major space-to-depth tensors
(CUDA, ``csrc/winograd.cu``), differentiable.

Replaces ``unet_implementations_tpu/kernels/winograd.py::_wino_s2d_pallas``
(``_wino_s2d_kernel``, and ``_wino_s2d_kernel_folded`` for the folded U).
``winograd_conv_s2d(x_s2d, kernel, bias)`` is the SAME stride-1 3×3 conv of
the dense map whose q-major space-to-depth is ``x_s2d`` (N, S/2, S/2, 4·Cin),
returned in the same layout (N, S/2, S/2, 4·Cout). One s2d pixel is one 2×2
output tile of F(2,3), so the input transform BᵀdB is made of channel-block
selects and unit shifts and the output tile is one s2d pixel. The
transform-domain products are [tiles, Cin] × [Cin, Cout] matrix products
against ``U = G w Gᵀ``: 16 of them (4/9 of the direct conv's multiply-adds),
or with the folded U (``transform_weights_folded``, ``_FOLDED``) 8 of K = 3·Cin
with the Aᵀ row combine folded into U.

Nothing in the port's ``UNet`` calls it, as nothing in the JAX ``UNet``
does: its entry point is this differentiable op. The backward follows the
JAX ``_wino_bwd``: dx is the same kernel on the cotangent with the flipped,
io-transposed kernel and a zero bias (a second launch); dW is the native conv
weight gradient on the dense views (``torch.nn.grad.conv2d_weight``, as JAX
leaves it to XLA); db is the float32 sum of the cotangent.

Kernels are in PyTorch's (Cout, Cin, 3, 3) layout, as everywhere in the
port; U keeps the JAX layout (16, Cin, Cout). Eligible shapes (``eligible``):
stride 1, 3×3, even dense sides of at least 8, Cin and Cout multiples of 128.

On a CPU tensor the plain version ``_torch_winograd_s2d`` runs: the JAX
kernel's arithmetic in torch ops (transforms in the input dtype, products in
float32, the output combine, the bias, one rounding). On a CUDA tensor the
kernel is launched, or the call raises (also for a shape ``eligible``
refuses). The kernel computes the input transform in float32 and rounds it
once to the dtype, where JAX rounds after each add in bf16; in float32 the
two agree to the order of the sums.

In bf16 the kernel is a warp-specialised wgmma loop that copies each chunk
of U into shared memory with one bulk copy: ``pack_weights`` lays U out for
it, once per call, beside the weight transform. The float32 kernel reads U
as it is.

Bound: the larger of the bytes (one read of x, one write of y) and the 16
products' operations at the bf16 tensor-core rate; see the source.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from unet_implementations_tpu_torch.kernels import _build
from unet_implementations_tpu_torch.models.s2d import depth_to_space, space_to_depth

# F(2,3) weight transform (correlation convention, like the conv).
_G = np.array([[1.0, 0.0, 0.0], [0.5, 0.5, 0.5], [0.5, -0.5, 0.5], [0.0, 0.0, 1.0]], np.float32)

# Fold the Aᵀ rows into the products' K dimension (8 products, K = 3·Cin).
# Off, as in the JAX package (winograd.py:362).
_FOLDED = False

# The bf16 kernel's blocks: 128 output channels (64 with the folded U) by
# chunks of 16 input channels (wgmma's K).
_COLS = {False: 128, True: 64}
_CHUNK = 16

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]


def transform_weights(kernel: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> (16, Cin, Cout) float32: U[4a+b] = (G w Gᵀ)[a, b]."""
    g = torch.from_numpy(_G).to(kernel.device)
    u = torch.einsum("ak,bl,oikl->abio", g, g, kernel.to(torch.float32))
    return u.reshape(16, kernel.shape[1], kernel.shape[0])


def transform_weights_folded(kernel: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> (8, 3·Cin, Cout) float32 with the Aᵀ row combine
    folded into K: z[2b+r] = concat_a(v_ab) @ UF[2b+r]. Aᵀ row 0 takes
    a ∈ {0, 1, 2} with signs (+, +, +), row 1 a ∈ {1, 2, 3} with (+, −, −)."""
    u = transform_weights(kernel).reshape(4, 4, kernel.shape[1], kernel.shape[0])
    rows = []
    for b in range(4):
        rows.append(torch.cat([u[0, b], u[1, b], u[2, b]], dim=0))
        rows.append(torch.cat([u[1, b], -u[2, b], -u[3, b]], dim=0))
    return torch.stack(rows)  # [2b + r]


def pack_weights(u: torch.Tensor) -> torch.Tensor:
    """U (16, Cin, Cout), or folded (8, 3·Cin, Cout), in the order the bf16
    kernel copies it: (Cout/N, Cin/16, mats, 2, N/8, 8, 8), N = 128 (folded
    64) output channels a block.

    U is taken as ``mats`` (Cin, Cout) matrices (folded: matrix 3·(2b+r) +
    idx is rows idx·Cin .. of UF[2b+r]), so 16 or 24 of them. Element [cb,
    ch, m, k8, n8, nr, kr] is matrix m at input channel 16·ch + 8·k8 + kr and
    output channel N·cb + 8·n8 + nr: each (column block cb, chunk ch) is one
    contiguous run, at offset (cb·Cin/16 + ch)·mats·16·N, of wgmma's
    no-swizzle core matrices (8 output channels × 8 input channels, K-major).
    """
    folded = u.shape[0] == 8
    mats = 24 if folded else 16
    cin, cout = u.shape[1] // (3 if folded else 1), u.shape[2]
    kc, n = _CHUNK, _COLS[folded]
    if cin % kc or cout % n:
        raise ValueError(f"pack_weights needs Cin a multiple of {kc} and Cout of {n}, "
                         f"got {cin} and {cout}")
    p = u.reshape(mats, cin // kc, kc // 8, 8, cout // n, n // 8, 8)
    return p.permute(4, 1, 0, 2, 5, 6, 3).contiguous()


def eligible(dense_shape, kernel_shape, stride: int) -> bool:
    """Winograd preconditions for a SAME conv of an NHWC ``dense_shape`` with
    a (Cout, Cin, kh, kw) kernel."""
    cout, cin, kh, kw = kernel_shape
    if stride != 1 or kh != 3 or kw != 3:
        return False
    _, h, w, _ = dense_shape
    return h % 2 == 0 and w % 2 == 0 and h >= 8 and w >= 8 and cin % 128 == 0 and cout % 128 == 0


def _shift_down(t: torch.Tensor) -> torch.Tensor:
    """t[:, :, j] <- t[:, :, j-1], zero at the start (dense column -1)."""
    return F.pad(t[:, :, :-1], (0, 0, 1, 0))


def _shift_up(t: torch.Tensor) -> torch.Tensor:
    """t[:, :, j] <- t[:, :, j+1], zero at the end (dense column S)."""
    return F.pad(t[:, :, 1:], (0, 0, 0, 1))


def _torch_winograd_s2d(x: torch.Tensor, u: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain version: the arithmetic of the JAX ``_wino_s2d_kernel`` (or
    ``_wino_s2d_kernel_folded`` when ``u`` is (8, 3·Cin, Cout)) over whole
    images.

    x: (N, GH, GW, 4·Cin) q-major; u in x's dtype; bias (Cout,) float32.
    The transforms run in x's dtype, the products in float32, and the
    output, with the bias, is rounded once to x's dtype.
    """
    n, gh, gw, c4 = x.shape
    c = c4 // 4
    cout = u.shape[-1]
    # Zero rows above and below: the SAME padding of dense rows -1 and S.
    p = F.pad(x, (0, 0, 0, 0, 1, 1))
    q00, q01, q10, q11 = p.split(c, dim=-1)

    def row_t(q0x, q1x):
        # Dense rows 2i-1, 2i, 2i+1, 2i+2 of tile row i.
        d0, d1, d2, d3 = q1x[:, :gh], q0x[:, 1:gh + 1], q1x[:, 1:gh + 1], q0x[:, 2:]
        return (d0 - d2, d1 + d2, d2 - d1, d1 - d3)

    te, to = row_t(q00, q10), row_t(q01, q11)  # column parity 0, 1
    v = []
    for a in range(4):
        c0, c1, c2, c3 = _shift_down(to[a]), te[a], to[a], _shift_up(te[a])
        v.append((c0 - c2, c1 + c2, c2 - c1, c1 - c3))
    uf = u.to(torch.float32)

    def product(vv, w):
        return vv.reshape(-1, vv.shape[-1]).to(torch.float32) @ w

    if u.shape[0] == 8:
        z = []
        for b in range(4):
            for r, trio in ((0, (0, 1, 2)), (1, (1, 2, 3))):
                z.append(product(torch.cat([v[a][b] for a in trio], dim=-1), uf[2 * b + r]))
    else:
        z = [None] * 8

        def acc(idx, val):
            z[idx] = val if z[idx] is None else z[idx] + val

        for a in range(4):
            for b in range(4):
                m = product(v[a][b], uf[4 * a + b])
                if a in (0, 1, 2):  # Aᵀ row 0 = [1, 1, 1, 0]
                    acc(2 * b, m)
                if a == 1:  # Aᵀ row 1 = [0, 1, -1, -1]
                    acc(2 * b + 1, m)
                elif a in (2, 3):
                    acc(2 * b + 1, -m)
    y = (z[0] + z[2] + z[4], z[2] - z[4] - z[6], z[1] + z[3] + z[5], z[3] - z[5] - z[7])
    bias = bias.to(torch.float32)
    out = torch.stack([(q + bias).to(x.dtype).reshape(n, gh, gw, cout) for q in y], dim=3)
    return out.reshape(n, gh, gw, 4 * cout)


def _cuda_winograd_s2d(x: torch.Tensor, u: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The kernel on U as it reads it: bf16 ``pack_weights(U)``, float32 U."""
    n, gh, gw, c4 = x.shape
    cin = c4 // 4
    if x.dtype not in _build.DTYPE_CODES or u.dtype != x.dtype:
        raise TypeError(f"winograd_conv_s2d takes float32 or bfloat16 x and U of its dtype, "
                        f"got {x.dtype} and {u.dtype}")
    if x.dtype == torch.bfloat16:
        folded = u.ndim == 7 and u.shape[2] == 24
        if u.ndim != 7 or u.shape[1] * _CHUNK != cin:
            raise ValueError(f"the bf16 kernel takes U from pack_weights for Cin {cin}, "
                             f"got {tuple(u.shape)}")
        cout = u.shape[0] * _COLS[folded]
    else:
        folded = u.shape[0] == 8
        cout = u.shape[-1]
    x, u = x.contiguous(), u.contiguous()
    bias = bias.to(torch.float32).contiguous()
    y = torch.empty((n, gh, gw, 4 * cout), dtype=x.dtype, device=x.device)
    if any(t.data_ptr() % 16 for t in (x, u, y)):
        raise ValueError("winograd_conv_s2d needs 16-byte aligned x and U")
    fn = _build.kernel_function("unet_winograd_s2d_fwd", _ARGTYPES)
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), u.data_ptr(), bias.data_ptr(), y.data_ptr(),
                  _build.DTYPE_CODES[x.dtype], int(folded), n, gh, gw, cin, cout,
                  _build.stream_of(x))
    _build.check(code, "unet_winograd_s2d_fwd")
    if folded:
        winograd_conv_s2d.launches_folded += 1
    else:
        winograd_conv_s2d.launches += 1
    return y


def _forward_s2d(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The kernel (CUDA) or its plain version (CPU) for a canonical kernel."""
    n, gh, gw, c4 = x.shape
    if c4 % 4 or kernel.shape[1] * 4 != c4:
        raise ValueError(f"x has {c4} s2d channels for a kernel of Cin {kernel.shape[1]}")
    tw = transform_weights_folded if _FOLDED else transform_weights
    u = tw(kernel).to(x.dtype)
    if not _build.uses_kernel(x, kernel, bias):
        return _torch_winograd_s2d(x, u, bias)
    if not eligible((n, 2 * gh, 2 * gw, c4 // 4), tuple(kernel.shape), 1):
        raise ValueError(f"winograd_conv_s2d: the dense shape {(n, 2 * gh, 2 * gw, c4 // 4)} "
                         f"with a {tuple(kernel.shape)} kernel is not eligible")
    return _cuda_winograd_s2d(x, pack_weights(u) if x.dtype == torch.bfloat16 else u, bias)


class _WinogradConvS2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, bias):
        ctx.save_for_backward(x, kernel)
        ctx.bias_dtype = bias.dtype
        return _forward_s2d(x, kernel, bias)

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            # SAME stride-1 conv of g with the flipped, io-transposed kernel:
            # again Winograd, again in s2d layout.
            k_flip = kernel.flip((2, 3)).transpose(0, 1)
            dx = _forward_s2d(g, k_flip, torch.zeros(k_flip.shape[0], dtype=torch.float32,
                                                     device=g.device))
        g_dense = depth_to_space(g) if ctx.needs_input_grad[1] or ctx.needs_input_grad[2] else None
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(depth_to_space(x).permute(0, 3, 1, 2), kernel.shape,
                                             g_dense.permute(0, 3, 1, 2), padding=1)
            dw = dw.to(kernel.dtype)
        if ctx.needs_input_grad[2]:
            db = g_dense.to(torch.float32).sum(dim=(0, 1, 2)).to(ctx.bias_dtype)
        return dx, dw, db


def winograd_conv_s2d(x_s2d: torch.Tensor, kernel: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """SAME stride-1 3×3 dense conv evaluated on a q-major s2d tensor.

    ``x_s2d``: (N, S/2, S/2, 4·Cin), the q-major space-to-depth of the dense
    (N, S, S, Cin) input; returns the s2d of the dense conv's output, in
    x's dtype. ``kernel``: the canonical dense (Cout, Cin, 3, 3), Cin and
    Cout multiples of 128; ``bias``: (Cout,). Differentiable in all three.
    """
    if x_s2d.ndim != 4:
        raise ValueError(f"winograd_conv_s2d takes (N, GH, GW, 4Cin), got {tuple(x_s2d.shape)}")
    return _WinogradConvS2d.apply(x_s2d, kernel, bias)


def winograd_conv(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Dense NHWC convenience wrapper: s2d -> kernel -> d2s. The layout
    changes cost an extra read and write of x and y; feed s2d tensors to
    ``winograd_conv_s2d`` directly where they exist."""
    return depth_to_space(winograd_conv_s2d(space_to_depth(x), kernel, bias))


# Kernel launches since the count was last set to 0 (CPU calls do not count):
# with the unfolded U (K4) and with the folded U (K4f).
winograd_conv_s2d.launches = 0
winograd_conv_s2d.launches_folded = 0
