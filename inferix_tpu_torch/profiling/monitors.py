"""Background resource monitors (port of `inferix_tpu/profiling/monitors.py`):
a BaseMonitor thread loop sampling at a configurable interval, a host
monitor (psutil CPU / RAM, /proc otherwise) and a device monitor (the card's
memory through `torch.cuda.memory_stats` and `torch.cuda.mem_get_info`)."""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import torch


class BaseMonitor:
    def __init__(self, interval_s: float = 1.0, max_samples: int = 10000):
        self.interval_s = interval_s
        self.max_samples = max_samples
        self.samples: List[Dict[str, Any]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def sample(self) -> Dict[str, Any]:
        raise NotImplementedError

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                s = self.sample()
                s["t"] = time.time()
                if len(self.samples) < self.max_samples:
                    self.samples.append(s)
            except Exception:
                pass
            self._stop.wait(self.interval_s)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval_s + 1)
            self._thread = None

    def summary(self) -> Dict[str, Any]:
        if not self.samples:
            return {}
        keys = [k for k in self.samples[0] if k != "t"]
        out = {}
        for k in keys:
            vals = [s[k] for s in self.samples if isinstance(s.get(k), (int, float))]
            if vals:
                out[k] = {"min": min(vals), "max": max(vals),
                          "avg": sum(vals) / len(vals)}
        return out


class HostMonitor(BaseMonitor):
    """CPU + RAM (psutil when present, /proc fallback)."""

    def sample(self) -> Dict[str, Any]:
        try:
            import psutil

            vm = psutil.virtual_memory()
            return {
                "cpu_percent": psutil.cpu_percent(interval=None),
                "ram_used_gb": vm.used / 2**30,
                "ram_percent": vm.percent,
            }
        except ImportError:
            with open("/proc/meminfo") as f:
                info = dict(
                    line.split(":")[0:1] + [line.split()[1]]
                    for line in f if ":" in line
                )
            total = int(info.get("MemTotal", 0))
            avail = int(info.get("MemAvailable", 0))
            return {
                "ram_used_gb": (total - avail) / 2**20,
                "ram_percent": 100.0 * (total - avail) / max(total, 1),
            }


class DeviceMonitor(BaseMonitor):
    """The card's memory: bytes allocated by PyTorch (current, peak) and the
    device's total, under the JAX monitor's keys. Without a CUDA device
    every value is 0, as the JAX monitor reads where its device reports no
    memory stats."""

    def __init__(self, interval_s: float = 1.0, max_samples: int = 10000,
                 device: str | torch.device = "cuda"):
        super().__init__(interval_s, max_samples)
        self.device = torch.device(device)

    def sample(self) -> Dict[str, Any]:
        if self.device.type != "cuda" or not torch.cuda.is_available():
            return {"hbm_in_use_gb": 0.0, "hbm_peak_gb": 0.0, "hbm_limit_gb": 0.0}
        stats = torch.cuda.memory_stats(self.device)
        return {
            "hbm_in_use_gb": stats.get("allocated_bytes.all.current", 0) / 2**30,
            "hbm_peak_gb": stats.get("allocated_bytes.all.peak", 0) / 2**30,
            "hbm_limit_gb": torch.cuda.mem_get_info(self.device)[1] / 2**30,
        }
