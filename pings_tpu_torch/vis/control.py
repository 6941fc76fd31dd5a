"""Headless live control of a running SLAM loop.

A copy of ``pings_tpu/vis/control.py``: the command-line frame loop polls
``<run_dir>/control.json`` at every frame boundary, so any other process
can pause, step or stop the run, change the vis cadence, or ask for mesh
and SDF-slice layers, without killing it.

Recognized fields (all optional):
  pause: bool         — block the loop (polled) until cleared
  step: int           — while paused, let N frames through, then re-pause
  stop: bool          — graceful end of run (results are still written)
  vis_every: int      — override the packet cadence (0 = off)
  mesh_on: bool       — include a reconstructed mesh in vis packets
  sdf_slice_on: bool  — include a horizontal SDF slice in vis packets
  sdf_slice_height: float — slice height (m) relative to the sensor
  render_on: bool     — include rendered rgb/depth views in vis packets
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional

DEFAULTS = {
    "pause": False,
    "step": 0,
    "stop": False,
    "vis_every": None,
    "mesh_on": False,
    "sdf_slice_on": False,
    "sdf_slice_height": 0.0,
    "render_on": True,
}


class ControlLoop:
    def __init__(self, run_dir: str):
        self.path = os.path.join(run_dir, "control.json")
        self._mtime = None
        self.state = dict(DEFAULTS)

    def poll(self) -> dict:
        """Re-read control.json if it changed; unknown keys are kept (so
        external UIs can round-trip their own state), malformed JSON is
        ignored until the next valid write."""
        try:
            mtime = os.stat(self.path).st_mtime_ns
        except OSError:
            return self.state
        if mtime == self._mtime:
            return self.state
        self._mtime = mtime
        try:
            with open(self.path) as f:
                data = json.load(f)
            if isinstance(data, dict):
                st = dict(DEFAULTS)
                st.update(data)
                self.state = st
        except (json.JSONDecodeError, OSError):
            pass
        return self.state

    def wait_if_paused(self, sleep_s: float = 0.2,
                       timeout_s: Optional[float] = None,
                       on_wait: Optional[Callable[[], None]] = None) -> bool:
        """Block while ``pause`` is set (honoring ``step``/``stop``).
        Returns False if ``stop`` was requested while waiting."""
        t0 = time.monotonic()
        while True:
            st = self.poll()
            if st.get("stop"):
                return False
            if not st.get("pause"):
                return True
            step = int(st.get("step") or 0)
            if step > 0:
                # consume one step credit and let one frame through
                st["step"] = step - 1
                self.state = st
                self._write(st)
                return True
            if timeout_s is not None and time.monotonic() - t0 > timeout_s:
                return True
            if on_wait is not None:
                on_wait()
            time.sleep(sleep_s)

    def _write(self, st: dict):
        """Atomic write-back (used to consume step credits)."""
        try:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(st, f)
            os.replace(tmp, self.path)
            self._mtime = os.stat(self.path).st_mtime_ns
        except OSError:
            pass
