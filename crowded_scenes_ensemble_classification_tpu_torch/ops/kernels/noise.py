"""Fused per-clip-gated salt/pepper noise: the CUDA kernel and its plain version.

Counterpart of `crowded_scenes_ensemble_classification_tpu/ops/pallas/noise.py`
(`salt_pepper_pallas`, line 52).  The kernel is `csrc/salt_pepper.cu`,
behind the custom op `csec::salt_pepper`.

Each element takes one 32-bit draw; its low 16 bits against
`max(65536 // ratio, 1)` decide salt (→255), its high 16 bits pepper (→0),
pepper after salt — the TPU kernel's rule.  The draws come from
Philox4x32-10 keyed by a 64-bit seed; `philox_bits` is the same generator
in PyTorch, so the kernel, the plain version and the CPU path all give the
same output for the same seed.
"""

from __future__ import annotations

import torch

from ._build import check_launch, load_library

_MASK32 = 0xFFFFFFFF
_MASK64 = (1 << 64) - 1
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def noise_threshold(ratio: int) -> int:
    """16-bit hit threshold (JAX ops/pallas/noise.py:73)."""
    return max(int(65536 // ratio), 1)


def _mulhilo32(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of the 64-bit product a·b for a 32-bit constant
    `a` and an int64 tensor `b` of 32-bit values, without int64 overflow."""
    t = a * (b & 0xFFFF)  # < 2^48
    u = a * (b >> 16) + (t >> 16)  # < 2^49
    return u >> 16, ((u & 0xFFFF) << 16) | (t & 0xFFFF)


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on int64 tensors holding 32-bit counter words; returns
    the four 32-bit output words as int64 tensors."""
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo32(_M0, c0)
        hi1, lo1 = _mulhilo32(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_bits(seed: int, batch: int, length: int, device) -> torch.Tensor:
    """(batch, length) int64 tensor of the 32-bit draws the kernel uses:
    element e of clip b is word e % 4 of philox((e // 4, b, 0, 0), seed)."""
    groups = (length + 3) // 4
    g = torch.arange(groups, dtype=torch.int64, device=device).expand(batch, groups)
    b = torch.arange(batch, dtype=torch.int64, device=device)[:, None].expand(batch, groups)
    zero = torch.zeros_like(g)
    words = philox4x32_10(g, b, zero, zero, seed & _MASK32, (seed >> 32) & _MASK32)
    return torch.stack(words, dim=-1).reshape(batch, 4 * groups)[:, :length]


def salt_pepper_reference(
    x: torch.Tensor,
    bits: torch.Tensor,
    salt_gates: torch.Tensor,
    pepper_gates: torch.Tensor,
    ratio: int,
) -> torch.Tensor:
    """Plain version with its random bits given: x (B, ...) float, bits
    (B, L) integers holding 32-bit draws (L = elements per clip), gates (B,)
    bool."""
    b = x.shape[0]
    thr = noise_threshold(ratio)
    bits = bits.to(torch.int64)
    flat = x.reshape(b, -1)
    salt = salt_gates.reshape(b, 1) & ((bits & 0xFFFF) < thr)
    out = torch.where(salt, torch.full_like(flat, 255.0), flat)
    pepper = pepper_gates.reshape(b, 1) & (((bits >> 16) & 0xFFFF) < thr)
    out = torch.where(pepper, torch.zeros_like(out), out)
    return out.reshape(x.shape)


def salt_pepper_plain(
    x: torch.Tensor,
    seed: int,
    salt_gates: torch.Tensor,
    pepper_gates: torch.Tensor,
    ratio: int,
) -> torch.Tensor:
    """Plain version drawing its bits from `philox_bits(seed)`: equal to the
    kernel on the same arguments."""
    b = x.shape[0]
    bits = philox_bits(seed, b, x[0].numel() if b else 0, x.device)
    return salt_pepper_reference(x, bits, salt_gates, pepper_gates, ratio)


# The op's schema carries the 64-bit seed as a signed int64: the wrapper
# passes its two's complement, the implementations mask it back.
@torch.library.custom_op("csec::salt_pepper", mutates_args=(), device_types="cpu")
def _salt_pepper_op(
    x: torch.Tensor, seed: int, salt_gates: torch.Tensor, pepper_gates: torch.Tensor, ratio: int
) -> torch.Tensor:
    return salt_pepper_plain(x, seed & _MASK64, salt_gates, pepper_gates, ratio)


@_salt_pepper_op.register_kernel("cuda")
def _salt_pepper_cuda(
    x: torch.Tensor, seed: int, salt_gates: torch.Tensor, pepper_gates: torch.Tensor, ratio: int
) -> torch.Tensor:
    if x.dtype != torch.float32:
        raise TypeError(f"salt_pepper: expected float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("salt_pepper: input must be contiguous")
    b = x.shape[0]
    length = x[0].numel() if b else 0
    if salt_gates.shape != (b,) or pepper_gates.shape != (b,):
        raise ValueError("salt_pepper: gates must have shape (B,)")
    if b > 65535 or length >= 4 << 32:
        raise ValueError(f"salt_pepper: batch {b} × length {length} out of range")
    lib = load_library()
    salt = salt_gates.to(device=x.device, dtype=torch.uint8).contiguous()
    pepper = pepper_gates.to(device=x.device, dtype=torch.uint8).contiguous()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.salt_pepper_f32(
            x.data_ptr(), y.data_ptr(), salt.data_ptr(), pepper.data_ptr(),
            b, length, seed & _MASK64, noise_threshold(ratio), stream,
        )
    check_launch("salt_pepper_f32", err)
    salt_pepper.launches += 1
    return y


@_salt_pepper_op.register_fake
def _salt_pepper_fake(x, seed, salt_gates, pepper_gates, ratio):
    return torch.empty(x.shape, dtype=x.dtype, device=x.device)


def salt_pepper(
    x: torch.Tensor,
    seed: int,
    salt_gates: torch.Tensor,
    pepper_gates: torch.Tensor,
    ratio: int,
) -> torch.Tensor:
    """x (B, ...) float32, seed a 64-bit int, gates (B,) bool → x with each
    element of a gated clip set to 255 (salt) / 0 (pepper) with probability
    ≈ 1/ratio.  CUDA tensors run the kernel; CPU tensors the plain version.
    `.launches` counts kernel launches."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"salt_pepper: unsupported device {x.device}")
    if not 0 <= seed < 1 << 64:
        raise ValueError("salt_pepper: seed must fit 64 unsigned bits")
    signed = seed - (1 << 64) if seed >= 1 << 63 else seed
    return _salt_pepper_op(x, signed, salt_gates, pepper_gates, ratio)


salt_pepper.launches = 0
