"""Fixed-point quantization emulating the paper's DSP48E1 arithmetic.

The paper trains with QKeras using Q2.5 for coefficients and Q3.4 for layer
outputs (1 sign bit + m integer bits + n fractional bits = 8 bits). Two
views of the same arithmetic live here, and they are bit-equivalent by
construction:

- **fake-quant** (:func:`quantize`): round-to-nearest-even onto the
  representable grid in f32, with a straight-through estimator so it can
  sit inside the training graph (quantization-aware training, like QKeras).
- **code emission** (:func:`to_int` / :func:`to_int8`): the integer codes
  the DSP48E1 (or the GPU's integer path) actually multiplies.

Both go through :func:`round_sat` — round half to even (``torch.round``),
saturate at the symmetric ``±(2^(bits-1) - 1)`` code — so
``fake_quant(x) == from_int(to_int(x))`` holds for *every* float input.

:class:`QuantSpec` packages the execution-plan view: which codes the
kernels multiply (Q3.4 activations x Q2.5 weights by default, or
calibrated per-cout weight scales) and the per-cout dequant row their
flush epilogue applies.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class QFormat:
    int_bits: int
    frac_bits: int

    @property
    def bits(self) -> int:
        return 1 + self.int_bits + self.frac_bits

    @property
    def scale(self) -> float:
        return float(2 ** self.frac_bits)

    @property
    def max_code(self) -> int:
        """Largest integer code: 2^(bits-1) - 1 (127 for 8-bit formats)."""
        return 2 ** (self.bits - 1) - 1

    @property
    def min_code(self) -> int:
        """Symmetric saturation: -max_code, NOT -2^(bits-1) — the DSP48E1
        pre-adder/negate path and the dequant epilogue both assume |code|
        <= max_code, and code emission must match fake-quant exactly."""
        return -self.max_code

    @property
    def max_val(self) -> float:
        return self.max_code / self.scale

    @property
    def min_val(self) -> float:
        return self.min_code / self.scale


Q2_5 = QFormat(2, 5)   # paper: network coefficients
Q3_4 = QFormat(3, 4)   # paper: layer outputs


def f32_parity_is_exact(k: int, x_fmt: "QFormat" = Q3_4,
                        w_fmt: "QFormat" = Q2_5) -> bool:
    """Whether an f32 accumulation of ``k`` saturated-code products is
    still *exact* — the precondition for the executed-int8 vs f32-QAT
    bit-parity asserts. Every partial sum is an integer multiple of the
    product LSB with magnitude ≤ k·max_code², and f32 represents integers
    exactly only below 2^24: at ``k·127² ≥ 2^24`` (k ≳ 1040, e.g. a 3×3
    conv over ≥116 channels) the f32 reference starts rounding while the
    int32 kernels stay exact, and parity degrades to a tolerance — guard
    hard equality asserts with this predicate."""
    return k * x_fmt.max_code * w_fmt.max_code < 2 ** 24


def round_sat(x_scaled: torch.Tensor, max_code) -> torch.Tensor:
    """The single rounding/saturation rule both views share: round half to
    even (``torch.round``), saturate at the symmetric ``±max_code``."""
    return torch.clamp(torch.round(x_scaled), -max_code, max_code)


class _FakeQuant(torch.autograd.Function):
    """Emit codes, then dequantize; backward is the clipped
    straight-through estimator (pass inside the representable range,
    zero outside)."""

    @staticmethod
    def forward(ctx, x, scale, min_val, max_val):
        ctx.save_for_backward(x)
        ctx.bounds = (min_val, max_val)
        return torch.clamp(torch.round(x * scale), min_val * scale,
                           max_val * scale) / scale

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        min_val, max_val = ctx.bounds
        pass_through = (x >= min_val) & (x <= max_val)
        return torch.where(pass_through, g, torch.zeros_like(g)), None, None, None


def fake_quant(x: torch.Tensor, scale: float, min_val: float,
               max_val: float) -> torch.Tensor:
    return _FakeQuant.apply(x, scale, min_val, max_val)


def quantize(x: torch.Tensor, fmt: QFormat) -> torch.Tensor:
    return fake_quant(x, fmt.scale, fmt.min_val, fmt.max_val)


def to_int(x: torch.Tensor, fmt: QFormat) -> torch.Tensor:
    """Integer codes (what the DSP48E1 actually multiplies), int32."""
    return round_sat(x * fmt.scale, fmt.max_code).to(torch.int32)


def to_int8(x: torch.Tensor, fmt: QFormat) -> torch.Tensor:
    """Integer codes as int8 — the kernel operand dtype. Saturation at
    ±max_code keeps every code in range, so the cast never wraps."""
    return round_sat(x * fmt.scale, fmt.max_code).to(torch.int8)


def from_int(codes: torch.Tensor, fmt: QFormat) -> torch.Tensor:
    return codes.to(torch.float32) / fmt.scale


@dataclasses.dataclass(frozen=True, eq=False)
class QuantSpec:
    """Quantization as a property of the *execution plan*: what int8 codes
    the kernels multiply and the per-cout dequant row their int32
    accumulator is flushed through.

    - ``w_scales is None`` (default): static paper formats — weights on the
      Q2.5 grid (scale ``2^5`` codes per unit for every cout), activations
      on Q3.4 (``2^4``).
    - ``w_scales`` set (see :meth:`calibrate`): per-cout weight scales
      (codes per unit, a host ``np.float32`` row), for weights whose
      dynamic range the static Q2.5 grid would clip — e.g. BN-folded
      kernels. ``a_scale`` optionally replaces the static activation scale.

    The dequant contract the kernels implement:
    ``out[m, n] = acc_int32[m, n] * dequant_row[n] (+ bias[n]) (relu)``
    with ``dequant_row[n] = 1 / (w_scale[n] * act_scale)``.
    """

    w_fmt: QFormat = Q2_5
    a_fmt: QFormat = Q3_4
    w_scales: Any = None               # (cout,) codes-per-unit, or None=static
    a_scale: Optional[float] = None    # codes-per-unit, or None=static

    @property
    def act_scale(self) -> float:
        return float(self.a_fmt.scale if self.a_scale is None else self.a_scale)

    def weight_scales(self, cout: int, device=None) -> torch.Tensor:
        """(cout,) codes-per-unit weight scale row."""
        if self.w_scales is None:
            return torch.full((cout,), self.w_fmt.scale, dtype=torch.float32,
                              device=device)
        ws = torch.as_tensor(np.asarray(self.w_scales, np.float32),
                             device=device)
        assert tuple(ws.shape) == (cout,), (tuple(ws.shape), cout)
        return ws

    def act_codes(self, x: torch.Tensor) -> torch.Tensor:
        """float activations -> int8 codes (round/saturate like fake-quant)."""
        return round_sat(x * self.act_scale, self.a_fmt.max_code).to(torch.int8)

    def weight_codes(self, w: torch.Tensor) -> torch.Tensor:
        """float weights (..., cout) -> int8 codes, per-cout scales applied.
        Zeros (e.g. masked pruned groups) stay exactly zero codes."""
        return round_sat(w * self.weight_scales(w.shape[-1], w.device),
                         self.w_fmt.max_code).to(torch.int8)

    def dequant_row(self, cout: int, device=None) -> torch.Tensor:
        """(cout,) f32 epilogue row: acc_int32 * row == float output."""
        return 1.0 / (self.weight_scales(cout, device) * self.act_scale)

    @classmethod
    def calibrate(cls, w: torch.Tensor, act_absmax: Optional[float] = None,
                  w_fmt: QFormat = Q2_5, a_fmt: QFormat = Q3_4) -> "QuantSpec":
        """Per-cout absmax calibration of the weight scales (and optionally
        a per-layer activation scale): each output channel's largest
        coefficient maps to ``±max_code``, so BN-folded weights quantize
        without clipping. The absmax is taken in the weight's own dtype,
        widened to f64 on the host, and the scale row is cast to f32 last.
        All-zero channels get the static scale."""
        cout = w.shape[-1]
        absmax = (torch.amax(torch.abs(w.reshape(-1, cout)), dim=0)
                  .detach().cpu().numpy().astype(np.float64))
        static = float(w_fmt.scale)
        w_scales = np.where(absmax > 0, w_fmt.max_code / np.maximum(absmax, 1e-30),
                            static).astype(np.float32)
        a_scale = (None if act_absmax is None
                   else float(a_fmt.max_code) / float(act_absmax))
        return cls(w_fmt=w_fmt, a_fmt=a_fmt, w_scales=w_scales, a_scale=a_scale)
