"""Device-spec registry: persisted, versioned calibrated HW constants.

A :class:`DeviceSpec` is one calibrated
:class:`~repro_torch.core.perf_model.HW` profile keyed by ``(device
kind, Geometry)`` — the same pair that decides which perf-model
constants apply to a plan. Specs are stored as one JSON file per key
under a registry directory so a fresh process starts from the last
calibration instead of the analytic defaults, and every recalibration
bumps the spec ``version`` (the Prometheus
``regraph_calibration_version`` gauge is exactly this number).

The device kind names the card (``torch.cuda.get_device_name``) and the
host, so a spec fitted on one card is only ever adopted on a card of
the same name.

Registry directory resolution: explicit ``root=`` argument, else the
``REGRAPH_SPEC_DIR`` environment variable, else ``.regraph_specs/`` under
the current working directory. Writes are atomic (tmp file + rename), so
concurrent services sharing a registry never observe a torn spec. The
file names and the JSON format are the reference package's.
"""
from __future__ import annotations

import dataclasses
import json
import os
import platform
import re
import tempfile
import time
from typing import Any, Dict, Optional

import torch

from ..core import perf_model
from ..core.types import Geometry
from ..kernels import ops

__all__ = ["DeviceSpec", "SpecRegistry", "default_device_kind",
           "geometry_key", "hw_to_dict", "hw_from_dict"]

_SPEC_FORMAT = 1


def hw_to_dict(hw: perf_model.HW) -> Dict[str, Any]:
    return dataclasses.asdict(hw)


def hw_from_dict(d: Dict[str, Any],
                 base: Optional[perf_model.HW] = None) -> perf_model.HW:
    """Tolerant deserialisation: unknown keys are dropped (older readers
    of newer specs), missing keys fall back to ``base`` (newer readers of
    older specs)."""
    base = base or perf_model.HW()
    names = {f.name for f in dataclasses.fields(perf_model.HW)}
    kept = {k: v for k, v in d.items() if k in names}
    return base.clone(**kept)


def geometry_key(geom: Geometry) -> str:
    return (f"U{geom.U}-W{geom.W}-T{geom.T}"
            f"-E{geom.E_BLK}-B{geom.big_batch}")


def default_device_kind(device=None) -> str:
    """The identity calibrated constants are keyed on:
    ``"<card name>@<host>"`` on a CUDA device, ``"cpu@<host>"`` for
    ``device="cpu"``. ``device`` resolves as every entry point's does
    (``cuda`` by default; raises when there is no CUDA device and
    ``device="cpu"`` was not passed). Constants are only portable
    across devices that share this string."""
    dev = ops.resolve_device(device)
    host = platform.node() or "host"
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else dev.type)
    return f"{kind}@{host}"


@dataclasses.dataclass
class DeviceSpec:
    """One calibrated HW profile for a (device kind, geometry) pair."""

    device_kind: str
    geom_key: str
    hw: perf_model.HW
    version: int = 0
    created_at: float = 0.0        # unix time of the calibration
    source: str = "analytic"       # "analytic" | "calibrated" | "bench"
    fit: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def peak_bandwidth_gbps(self) -> float:
        """The bandwidth this spec's model believes in: the explicit
        calibrated ``HW.peak_bandwidth_gbps`` when set, else the
        bandwidth the fitted stream terms imply
        (:func:`~repro_torch.core.perf_model.effective_peak_bandwidth_bps`).
        The utilization profiler's %-of-peak on the card divides by
        :func:`~repro_torch.core.perf_model.peak_bandwidth_bps` instead."""
        return perf_model.effective_peak_bandwidth_bps(self.hw) / 1e9

    def age_s(self, now: Optional[float] = None) -> float:
        if self.created_at <= 0:
            return float("inf")
        return max(0.0, (now if now is not None else time.time())
                   - self.created_at)

    def to_json(self) -> Dict[str, Any]:
        return {
            "format": _SPEC_FORMAT,
            "device_kind": self.device_kind,
            "geom_key": self.geom_key,
            "hw": hw_to_dict(self.hw),
            "version": int(self.version),
            "created_at": float(self.created_at),
            "source": self.source,
            "fit": self.fit,
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "DeviceSpec":
        fit = d.get("fit") or {}
        if not isinstance(fit, dict):
            fit = {}
        return cls(
            device_kind=str(d["device_kind"]),
            geom_key=str(d["geom_key"]),
            hw=hw_from_dict(d.get("hw") or {}),
            version=int(d.get("version", 0)),
            created_at=float(d.get("created_at", 0.0)),
            source=str(d.get("source", "calibrated")),
            fit=fit,
        )


def _safe(token: str) -> str:
    return re.sub(r"[^A-Za-z0-9._-]+", "_", token)


class SpecRegistry:
    """Filesystem-backed spec store, one JSON file per (kind, geometry).

    ``get`` returns ``None`` for absent or unreadable files (a corrupt
    spec degrades to analytic defaults, never crashes startup); ``put``
    persists atomically and creates the directory on first use.
    """

    def __init__(self, root: Optional[str] = None):
        self.root = str(root or os.environ.get("REGRAPH_SPEC_DIR")
                        or os.path.join(os.getcwd(), ".regraph_specs"))

    def path_for(self, device_kind: str, geom) -> str:
        """``geom`` is a Geometry or an already-computed geom_key string."""
        gkey = geom if isinstance(geom, str) else geometry_key(geom)
        name = f"{_safe(device_kind)}__{_safe(gkey)}.json"
        return os.path.join(self.root, name)

    def get(self, device_kind: str, geom: Geometry) -> Optional[DeviceSpec]:
        path = self.path_for(device_kind, geom)
        try:
            with open(path, "r", encoding="utf-8") as f:
                return DeviceSpec.from_json(json.load(f))
        except (OSError, ValueError, KeyError, TypeError):
            return None

    def put(self, spec: DeviceSpec) -> str:
        """Atomically persist ``spec``; returns the file path."""
        path = self.path_for(spec.device_kind, spec.geom_key)
        os.makedirs(self.root, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(spec.to_json(), f, indent=2, sort_keys=True)
                f.write("\n")
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return path

    def get_or_default(self, device_kind: str, geom: Geometry,
                       hw: Optional[perf_model.HW] = None) -> DeviceSpec:
        """The persisted spec, else an analytic one over ``hw`` (default
        :data:`~repro_torch.core.perf_model.DEFAULT_HW`)."""
        spec = self.get(device_kind, geom)
        if spec is not None:
            return spec
        return DeviceSpec(device_kind=device_kind,
                          geom_key=geometry_key(geom),
                          hw=hw or perf_model.DEFAULT_HW,
                          source="analytic")
