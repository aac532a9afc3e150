"""Analytic model FLOPs and the roofline of one card, the twin of the JAX
package's ``launch/analysis.py``.

Hardware constants: one NVIDIA H100 SXM, from NVIDIA's H100 data sheet
(dense rates, no sparsity, at the 700 W power limit):

- ``HBM_BW`` 3.35 TB/s, the HBM3 rate (the figure ``PERF.md`` §6 bounds
  every kernel by);
- ``PEAK_INT8`` 1979 TOP/s, the int8 tensor-core row (also ``PERF.md``
  §6's);
- ``PEAK_FLOPS`` (bf16 dense) half of that row, 989.5 TFLOP/s, from the
  same table's bf16 tensor-core row;
- ``LINK_BW`` 900 GB/s of NVLink per GPU, from the same data sheet, in
  the place of the TPU's ICI link.

:func:`device_peaks` reads what the card at hand has (SM count, memory,
clocks) at run time.

The JAX module also reads XLA's compiled artifacts: ``parse_collectives``
counts the collective ops of the HLO text, ``cost_of`` reads
``compiled.cost_analysis()`` and ``memory_of`` ``memory_analysis()``.
PyTorch runs eagerly and produces no such artifact, so they have no twin
here. The port's dry-run (``launch/dryrun.py``) measures instead, on meta
tensors: FLOPs with ``torch.utils.flop_counter.FlopCounterMode``, bytes as
the sum of every operation's tensor inputs and outputs (an unfused upper
bound), argument bytes per device from the sharding specs, and the
activations autograd saves. It does not model collectives.
"""
from __future__ import annotations

import dataclasses
import subprocess
from typing import Dict, Optional

from ..models.lm_config import LMConfig

PEAK_INT8 = 1979e12          # int8 / card
PEAK_FLOPS = PEAK_INT8 / 2   # bf16 / card
HBM_BW = 3.35e12             # bytes/s / card
LINK_BW = 900e9              # bytes/s / card (NVLink)
HBM_BYTES = 80 * 1024 ** 3   # H100 80 GB, the memory a card is assumed to have


# ---------------------------------------------------------------------------
# Analytic model FLOPs (the MODEL_FLOPS / counted FLOPs "useful compute" ratio)
# ---------------------------------------------------------------------------

def model_flops(cfg: LMConfig, shape_kind: str, seq_len: int, global_batch: int) -> float:
    """6·N_active·tokens (train) / 2·N_active·tokens (prefill) /
    2·N_active·batch (decode) + the quadratic attention term (causal)."""
    n_active = cfg.active_param_count()
    tokens = seq_len * global_batch
    d_attn = cfg.num_heads * cfg.head_dim
    n_attn_layers = _attn_layer_count(cfg)
    if shape_kind == "train":
        attn = 2.0 * global_batch * seq_len ** 2 * d_attn * n_attn_layers * 3  # fwd×1 + bwd×2
        return 6.0 * n_active * tokens + attn
    if shape_kind == "prefill":
        attn = 2.0 * global_batch * seq_len ** 2 * d_attn * n_attn_layers
        return 2.0 * n_active * tokens + attn
    # decode: one token, attention linear in KV length
    attn = 4.0 * global_batch * seq_len * d_attn * n_attn_layers
    return 2.0 * n_active * global_batch + attn


def _attn_layer_count(cfg: LMConfig) -> int:
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.hybrid_attn_every
    if cfg.family == "ssm":
        return 0
    return cfg.num_layers


@dataclasses.dataclass
class Roofline:
    """The least time ``chips`` cards take for ``flops`` operations and
    ``bytes`` of memory traffic (totals over the cards), and for
    ``coll_bytes`` over their links when the collective term is modeled
    (``None``: not modeled; its terms are then ``None`` and ``dominant`` is
    taken over the others)."""
    chips: int
    flops: float
    bytes: float
    coll_bytes: Optional[float]

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> Optional[float]:
        if self.coll_bytes is None:
            return None
        return self.coll_bytes / (self.chips * LINK_BW)

    def _terms(self) -> Dict[str, float]:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return {k: v for k, v in terms.items() if v is not None}

    @property
    def dominant(self) -> str:
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self._terms().values())

    def as_dict(self) -> Dict:
        return {
            "chips": self.chips,
            "counted_flops": self.flops,
            "counted_bytes": self.bytes,
            "collective_bytes": self.coll_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
        }


def _smi_clocks() -> Dict[str, Optional[float]]:
    """The card's maximum and current SM and memory clocks (MHz), as
    ``nvidia-smi`` reads them; ``None`` where it cannot."""
    keys = ("clocks.max.sm", "clocks.max.mem", "clocks.sm", "clocks.mem")
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(keys)}", "--format=csv,noheader,nounits"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, timeout=60)
        vals = out.stdout.strip().splitlines()[0].split(",")
        return {k.replace(".", "_") + "_mhz": float(v) for k, v in zip(keys, vals)}
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return {k.replace(".", "_") + "_mhz": None for k in keys}


def device_peaks(device=None) -> Dict:
    """The card's own figures, read at run time (SM count, total memory,
    clocks), beside the data sheet's peaks this module bounds by. Without
    a CUDA device: the data sheet's figures and 80 GiB of memory, with
    ``device`` ``None``."""
    import torch
    out = {"peak_bf16_flops": PEAK_FLOPS, "peak_int8_ops": PEAK_INT8,
           "hbm_bytes_per_s": HBM_BW, "link_bytes_per_s": LINK_BW}
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return {**out, "device": None, "memory_bytes": HBM_BYTES, "sm_count": None}
    props = torch.cuda.get_device_properties(dev)
    return {**out, "device": props.name, "memory_bytes": int(props.total_memory),
            "sm_count": int(props.multi_processor_count), **_smi_clocks()}
