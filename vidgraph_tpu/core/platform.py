"""Platform probing — JAX device discovery instead of torch (reference:
src/core/platform.py:6-39 probes torch cuda/mps; here the accelerator is
discovered through ``jax.devices()``)."""
from __future__ import annotations

import os
import platform
import sys
from pathlib import Path
from typing import List


class PlatformUtils:
    @staticmethod
    def get_worker_count() -> int:
        return max(1, (os.cpu_count() or 2) - 1)

    @staticmethod
    def get_video_backend() -> str:
        if sys.platform == "darwin":
            return "avfoundation"
        return "opencv"

    @staticmethod
    def get_accelerator() -> str:
        """'gpu' or 'cpu' (or another JAX platform name) for the default
        JAX backend."""
        import jax

        try:
            return jax.default_backend()
        except Exception:
            return "cpu"

    @staticmethod
    def get_devices() -> List["object"]:
        import jax

        return list(jax.devices())

    @staticmethod
    def device_count() -> int:
        import jax

        return jax.device_count()

    @staticmethod
    def get_data_dir(app: str = "vidgraph") -> Path:
        if sys.platform == "darwin":
            base = Path.home() / "Library" / "Application Support"
        elif platform.system() == "Windows":
            base = Path(os.environ.get("APPDATA", Path.home()))
        else:
            base = Path(os.environ.get("XDG_DATA_HOME",
                                       Path.home() / ".local" / "share"))
        d = base / app
        d.mkdir(parents=True, exist_ok=True)
        return d
