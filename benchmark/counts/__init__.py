"""Operation and byte counts of the work a configuration's mathematics needs,
from the shapes the benchmark drives, whatever kernels the program runs it
with. A `Work` item is one kind of work summed over its calls: its
category (which metric reads it), the precision whose published peak bounds
it, and its operations and bytes (each input read once, each output written
once)."""
from __future__ import annotations

from typing import NamedTuple


class Work(NamedTuple):
    category: str      # "self_attention", "linear", "cross_attention", "vae_conv", "vae_attention"
    precision: str     # a key of peaks.json's "ops_per_s"
    ops: float
    bytes: float


def attention(category: str, q: int, keys: int, heads: int, head_dim: int, calls: int = 1,
              precision: str = "bf16", itemsize: int = 2, kv_itemsize: int = 2,
              kv_scale_bytes: int = 0) -> Work:
    """softmax(q k^T) v of `q` query rows over `keys` keys a head: 2 q keys d
    for the logits and 2 q keys d for p v, a head; Q and O once at
    `itemsize`, K and V once at `kv_itemsize`, plus `kv_scale_bytes` a key a
    head for each of K and V (an int8 cache's scales)."""
    ops = 4.0 * q * keys * head_dim * heads
    nbytes = (2.0 * q * heads * head_dim * itemsize
              + 2.0 * keys * heads * (head_dim * kv_itemsize + kv_scale_bytes))
    return Work(category, precision, ops * calls, nbytes * calls)


def linear(category: str, m: int, k: int, n: int, calls: int = 1, precision: str = "bf16",
           itemsize: int = 2) -> Work:
    """[m, k] @ [k, n] (+ bias): 2 m k n operations; x, w and the output
    once."""
    return Work(category, precision, 2.0 * m * k * n * calls,
                float(itemsize) * (m * k + k * n + m * n + n) * calls)


def conv3d(category: str, t: int, h: int, w: int, cin: int, cout: int, kernel,
           precision: str = "bf16", itemsize: int = 2) -> Work:
    """A stride-1 conv giving [t, h, w, cout] from Cin channels with a
    kt x kh x kw kernel: 2 t h w cout cin kt kh kw operations; the input
    (with its kt - 1 cached frames), the weights and the output once."""
    kt, kh, kw = kernel
    ops = 2.0 * t * h * w * cout * cin * kt * kh * kw
    nbytes = itemsize * ((t + kt - 1) * h * w * cin + kt * kh * kw * cin * cout
                         + t * h * w * cout + cout)
    return Work(category, precision, ops, float(nbytes))


def least_time(work: Work, peaks: dict) -> float:
    """Seconds the chip needs at least: the larger of the operations at the
    precision's peak and the bytes at the memory bandwidth."""
    return max(work.ops / peaks["ops_per_s"][work.precision],
               work.bytes / peaks["bytes_per_s"])


def ops_time(work: Work, peaks: dict) -> float:
    """The operations alone at the precision's peak (what MFU counts)."""
    return work.ops / peaks["ops_per_s"][work.precision]
