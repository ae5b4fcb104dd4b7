"""Energy model (paper §4, Tables 1-2, Horowitz 2014, 45nm; port of
`repro.core.energy`, pure Python: the same tables and formulas).

Counts MAC-equivalent operations for a model/op graph and prices them with
the paper's per-op energies, reproducing the "two orders of magnitude"
estimate and the benchmark tables.
"""
from __future__ import annotations

from dataclasses import dataclass, field

# Table 1 — pJ per operation (Horowitz 2014)
ENERGY_PJ = {
    ("mul", "int8"): 0.2,
    ("mul", "int32"): 3.1,
    ("mul", "fp16"): 1.1,
    ("mul", "fp32"): 3.7,
    ("add", "int8"): 0.03,
    ("add", "int32"): 0.1,
    ("add", "fp16"): 0.4,
    ("add", "fp32"): 0.9,
}
# Paper §4: addition energy is linear in bit-width; +-1 operands are 2-bit,
# so a binary accumulate costs (2/8) of an int8 add. XNOR/popcount are
# priced as bitwise ops at the same 2-bit adder unit cost.
ENERGY_PJ[("add", "int2")] = ENERGY_PJ[("add", "int8")] * 2 / 8
ENERGY_PJ[("xnor_popcount_word", "b32")] = ENERGY_PJ[("add", "int2")]

# Table 2 — memory access pJ per 64-bit word by cache size
MEM_PJ = {8 * 1024: 10.0, 32 * 1024: 20.0, 1024 * 1024: 100.0}


def mem_access_pj(nbytes_working_set: int) -> float:
    """pJ per 64-bit access for the smallest cache the working set fits."""
    for size, pj in sorted(MEM_PJ.items()):
        if nbytes_working_set <= size:
            return pj
    return MEM_PJ[1024 * 1024]


@dataclass
class EnergyLedger:
    """Accumulates op counts and prices them."""
    counts: dict = field(default_factory=dict)

    def add(self, op: str, dtype: str, n: int) -> None:
        key = (op, dtype)
        if key not in ENERGY_PJ:
            raise KeyError(f"no energy entry for {key}")
        self.counts[key] = self.counts.get(key, 0) + int(n)

    def total_pj(self) -> float:
        return sum(ENERGY_PJ[k] * n for k, n in self.counts.items())


def dense_layer_energy(m: int, k: int, n: int, *, mode: str) -> EnergyLedger:
    """Energy of an (m,k) x (k,n) matmul.

    mode: 'fp32'  — k MULs + k ADDs per output (standard MAC)
          'fp16'  — same in half precision
          'bc'    — BinaryConnect: weights binary => MULs become fp adds
                    (sign flips), accumulation stays fp
          'bbp'   — fully binarized: XNOR+popcount over 32-bit words,
                    one int accumulate per word + final int->scale add
    """
    led = EnergyLedger()
    outs = m * n
    if mode in ("fp32", "fp16"):
        led.add("mul", mode, outs * k)
        led.add("add", mode, outs * k)
    elif mode == "bc":
        # multiply by +-1 == conditional negate: price as fp add; plus accum
        led.add("add", "fp32", outs * k * 2)
    elif mode == "bbp":
        words = (k + 31) // 32
        led.add("xnor_popcount_word", "b32", outs * words)
        led.add("add", "int32", outs * words)  # popcount accumulation
    else:
        raise ValueError(mode)
    return led


def conv_layer_energy(cin: int, cout: int, k: int, h: int, w: int, *,
                      mode: str, unique_kernel_fraction: float = 1.0
                      ) -> EnergyLedger:
    """Energy of a k x k conv producing (cout, h, w); §4.2 kernel-dedup
    scales the binary op count by the unique-kernel fraction."""
    led = dense_layer_energy(h * w, cin * k * k, cout, mode=mode)
    if mode == "bbp" and unique_kernel_fraction < 1.0:
        # §4.2: only unique 2D kernels are convolved — BOTH the XNOR words
        # and their popcount accumulations are skipped for repeats
        led.counts = {kk: int(n * unique_kernel_fraction)
                      for kk, n in led.counts.items()}
    return led
