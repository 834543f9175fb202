"""The Siren layer's epilogue on the card (`csrc/siren_act.cu`): the bias
add, the rounding to the compute dtype, the w0 product and `fast_sin` in one
launch, and their backward in one launch.

`forward` and `backward` take CUDA tensors only and raise on anything the
kernels do not take; `spnerf_torch.models.spnerf.SineLayer` routes to them
on CUDA tensors, counts the launches, and runs the plain version on CPU
tensors. The library is built the first time a call needs it.
"""

import ctypes

import torch

_LIB = None


def _lib():
    """The library, its entry points' argtypes set once."""
    global _LIB
    if _LIB is None:
        from . import _build

        lib = _build.load("siren_act")
        ptr, i32, f32, i64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                              ctypes.c_longlong)
        lib.spnerf_siren_act_forward.argtypes = [ptr, ptr, f32, ptr, ptr, i64,
                                                 i32, i32, ptr]
        lib.spnerf_siren_act_backward.argtypes = [ptr, ptr, f32, ptr, i64,
                                                  i32, ptr]
        for fn in (lib.spnerf_siren_act_forward,
                   lib.spnerf_siren_act_backward):
            fn.restype = i32
        lib.spnerf_siren_act_error_string.argtypes = [i32]
        lib.spnerf_siren_act_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(lib, err, name):
    if err:
        raise RuntimeError(f"siren_act {name} launch failed: "
                           + lib.spnerf_siren_act_error_string(err).decode())


def _bf16(dtype):
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the siren_act kernels take bfloat16 or float32, "
                         f"got {dtype}")
    return int(dtype == torch.bfloat16)


def forward(y, bias, w0, compute_dtype):
    """(s, z) of a Siren layer from its float32 product y (N, W) and float32
    bias (W,): z = round(w0 * round(y + bias)), the backward's input, and
    s = round(fast_sin(z)), both in `compute_dtype`."""
    bf16 = _bf16(compute_dtype)
    if y.device.type != "cuda" or bias.device != y.device:
        raise ValueError(f"the siren_act kernels take CUDA tensors on one "
                         f"device, got y on {y.device}, bias on {bias.device}")
    if y.dtype != torch.float32 or bias.dtype != torch.float32:
        raise ValueError(f"y and bias must be float32, got {y.dtype}, "
                         f"{bias.dtype}")
    if y.dim() != 2 or bias.shape != (y.shape[1],):
        raise ValueError(f"y {tuple(y.shape)} and bias {tuple(bias.shape)} "
                         f"are not (N, W) and (W,)")
    y, bias = y.contiguous(), bias.contiguous()
    s = torch.empty(y.shape, dtype=compute_dtype, device=y.device)
    z = torch.empty_like(s)
    lib = _lib()
    err = lib.spnerf_siren_act_forward(
        y.data_ptr(), bias.data_ptr(), float(w0), s.data_ptr(), z.data_ptr(),
        y.shape[0], y.shape[1], bf16,
        torch._C._cuda_getCurrentRawStream(y.device.index))
    _check(lib, err, "forward")
    return s, z


def backward(gs, z, w0):
    """The float32 gradient of the product y from the gradient gs of s and
    the kept z (both of the compute dtype): round(w0 * round(gs *
    fast_sin'(z)))."""
    bf16 = _bf16(z.dtype)
    if z.device.type != "cuda" or gs.device != z.device:
        raise ValueError(f"the siren_act kernels take CUDA tensors on one "
                         f"device, got gs on {gs.device}, z on {z.device}")
    if gs.dtype != z.dtype or gs.shape != z.shape:
        raise ValueError(f"gs {gs.dtype} {tuple(gs.shape)} does not match z "
                         f"{z.dtype} {tuple(z.shape)}")
    # the skip layer's concatenation hands its first operand a strided slice
    gs, z = gs.contiguous(), z.contiguous()
    gy = torch.empty(z.shape, dtype=torch.float32, device=z.device)
    lib = _lib()
    err = lib.spnerf_siren_act_backward(
        gs.data_ptr(), z.data_ptr(), float(w0), gy.data_ptr(), z.numel(), bf16,
        torch._C._cuda_getCurrentRawStream(z.device.index))
    _check(lib, err, "backward")
    return gy
