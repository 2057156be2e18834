"""Device + config + error handling — the rtcore_device.h API surface.

Port of embree_tpu/rtcore.py. Role parity with the reference device layer
(kernels/common/device.{h,cpp}:
Device::Device :50-137 config parse + setup, Device::getProperty :438;
kernels/common/state.{h,cpp}: State::parseString :224 — 40+ config keys;
error model rtcore.h RTC_CATCH_*, rtcSetDeviceErrorFunction rtcore_device.h:117,
memory monitor :120).

There is no ISA selection or thread pool to configure; the analogous knobs
are build quality, tessellation rates and the native builder's threads,
and everything else is accepted and recorded for config-string parity. A
Device names the torch device its scenes commit to (CUDA unless the caller
passes device="cpu"); its "platform" and "device_count" properties come
from torch, where the JAX package reads jax.devices().
"""
from __future__ import annotations

import dataclasses
import traceback
from typing import Callable, Dict, Optional

import torch

from . import __version__ as _version
from .core.ray import resolve_device
from .query import ARRAY_FIELDS
from .scene import BuildQuality, CommitCancelled, Scene

# RTCError codes (rtcore_common.h)
ERROR_NONE = 0
ERROR_UNKNOWN = 1
ERROR_INVALID_ARGUMENT = 2
ERROR_INVALID_OPERATION = 3
ERROR_OUT_OF_MEMORY = 4
ERROR_UNSUPPORTED_CPU = 5
ERROR_CANCELLED = 6


@dataclasses.dataclass
class DeviceConfig:
    """Parsed device configuration (State analog, state.h:54-157)."""
    threads: int = 0
    verbose: int = 0
    quality: int = BuildQuality.MEDIUM
    tessellation_rate: int = 8
    max_leaf_size: int = 4
    robust: bool = False
    # RTC_SCENE_FLAG_COMPACT analog: drop the unpacked per-kind tables when
    # the packed kernel table can serve hits alone (state.h compact accels)
    compact: bool = False
    # spatial-split replication budget (state.h:117, default 1.2)
    max_spatial_split_replications: float = 1.2
    raw: Dict[str, str] = dataclasses.field(default_factory=dict)

    _QUALITY = {"low": BuildQuality.LOW, "medium": BuildQuality.MEDIUM,
                "high": BuildQuality.HIGH, "refit": BuildQuality.REFIT}

    @classmethod
    def parse(cls, cfg: Optional[str]) -> "DeviceConfig":
        """Parse an Embree-style config string: "key=value,key=value,flag"
        (State::parseString analog). Unknown keys are recorded, not rejected
        (reference behavior: ignored with verbose warning)."""
        self = cls()
        if not cfg:
            return self
        for item in cfg.split(","):
            item = item.strip()
            if not item:
                continue
            key, _, val = item.partition("=")
            key = key.strip()
            val = val.strip()
            self.raw[key] = val
            if key == "threads":
                self.threads = int(val or 0)
            elif key == "verbose":
                self.verbose = int(val or 1)
            elif key in ("quality", "default_quality"):
                self.quality = self._QUALITY[val.lower()]
            elif key == "tessellation_rate":
                self.tessellation_rate = int(val)
            elif key == "max_leaf_size":
                self.max_leaf_size = int(val)
            elif key == "robust":
                self.robust = val in ("", "1", "true")
            elif key == "compact":
                self.compact = val in ("", "1", "true")
            elif key == "max_spatial_split_replications":
                self.max_spatial_split_replications = float(val)
        return self


class Device:
    """rtcNewDevice analog: owns config, error state, and scene creation."""

    def __init__(self, config: Optional[str] = None, device=None):
        self.config = DeviceConfig.parse(config)
        self.device = resolve_device(device)
        self._error_code = ERROR_NONE
        self._error_msg = ""
        self._error_fn: Optional[Callable] = None
        self._memory_monitor: Optional[Callable] = None
        self._bytes_allocated = 0
        if self.config.verbose >= 1:
            print(f"embree_tpu_torch {_version} on {self.device.type} "
                  f"({self._device_count()} device(s))")
        if self.config.verbose >= 2:
            print(f"  config: {self.config}")

    def _device_count(self) -> int:
        return (torch.cuda.device_count() if self.device.type == "cuda"
                else 1)

    # ---- error model (Device::setDeviceErrorCode analog) ----
    def set_error_function(self, fn: Callable):
        """rtcSetDeviceErrorFunction analog: fn(code, message)."""
        self._error_fn = fn

    def get_error(self):
        """rtcGetDeviceError analog: returns and clears the last error."""
        code, msg = self._error_code, self._error_msg
        self._error_code, self._error_msg = ERROR_NONE, ""
        return code, msg

    def _record_error(self, code, msg):
        self._error_code, self._error_msg = code, msg
        if self._error_fn is not None:
            self._error_fn(code, msg)

    # ---- memory monitor (rtcSetDeviceMemoryMonitorFunction analog) ----
    def set_memory_monitor(self, fn: Callable):
        """fn(bytes, post) -> bool; returning False vetoes the allocation
        (MemoryMonitorTest semantics: commit raises, scene stays valid)."""
        self._memory_monitor = fn

    def _monitor(self, nbytes: int) -> None:
        self._bytes_allocated += nbytes
        if self._memory_monitor is not None:
            if not self._memory_monitor(nbytes, True):
                raise MemoryError("allocation vetoed by memory monitor")

    # ---- properties (rtcGetDeviceProperty analog, rtcore_device.h:49-81) ----
    def get_property(self, name: str):
        props = {
            "version": _version,
            "version_major": int(_version.split(".")[0]),
            "triangle_geometry_supported": True,
            "quad_geometry_supported": True,
            "curve_geometry_supported": True,
            "point_geometry_supported": True,
            "user_geometry_supported": True,
            "subdivision_geometry_supported": True,
            "ray_mask_supported": True,
            "filter_function_supported": True,
            "backface_culling_enabled": False,
            "ignore_invalid_rays_enabled": True,
            "native_ray4_supported": True,   # batch queries are native
            "native_ray8_supported": True,
            "native_ray16_supported": True,
            "max_instance_level_count": 2,
            "platform": self.device.type,
            "device_count": self._device_count(),
        }
        return props[name]

    # ---- scene factory ----
    def new_scene(self, quality: Optional[int] = None,
                  robust: Optional[bool] = None) -> Scene:
        scene = Scene(quality=self.config.quality if quality is None else quality,
                      robust=self.config.robust if robust is None else robust,
                      threads=self.config.threads,
                      compact=self.config.compact,
                      max_spatial_split_replications=(
                          self.config.max_spatial_split_replications))
        scene._device = self
        return scene

    def commit_scene(self, scene: Scene):
        """Commit on the device with error capture (RTC_CATCH_BEGIN/END
        analog); the memory monitor sees the bytes of the scene's table
        tensors (the BVH and the packed records are not counted, as in the
        JAX package)."""
        try:
            cs = scene.commit(device=self.device)
            nbytes = sum(getattr(cs, f).numel() * getattr(cs, f).element_size()
                         for f in ARRAY_FIELDS
                         if torch.is_tensor(getattr(cs, f, None)))
            self._monitor(nbytes)
            return cs
        except CommitCancelled as e:
            self._record_error(ERROR_CANCELLED, str(e))
            raise
        except MemoryError as e:
            self._record_error(ERROR_OUT_OF_MEMORY, str(e))
            raise
        except ValueError as e:
            self._record_error(ERROR_INVALID_ARGUMENT, str(e))
            raise
        except Exception as e:  # noqa: BLE001
            self._record_error(ERROR_UNKNOWN,
                               "".join(traceback.format_exception_only(e)))
            raise
