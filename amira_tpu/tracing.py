"""Phase timing and profiling.

The reference has no tracing (SURVEY §5.1: tqdm loops and one wall-clock
total). Here every pipeline stage runs under a named phase timer; a summary
(with reads/sec for the graph-build phases) is printed at exit and written to
<output>/phase_timings.json. Set AMIRA_TPU_PROFILE=<dir> to additionally
capture a jax.profiler trace of the device work.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from contextlib import contextmanager


class PhaseTimer:
    """Phase records are per thread, so concurrent isolate streams
    (amira_tpu/batch.py) each time and report their own pipeline."""

    def __init__(self):
        self._local = threading.local()
        self._profile_dir = os.environ.get("AMIRA_TPU_PROFILE")
        self._profiling = False

    @property
    def phases(self) -> list[dict]:
        if not hasattr(self._local, "phases"):
            self._local.phases = []
        return self._local.phases

    @property
    def _stack(self) -> list[tuple[str, float, dict]]:
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    @contextmanager
    def phase(self, name: str, **meta):
        if self._profile_dir and not self._profiling:
            import jax

            jax.profiler.start_trace(self._profile_dir)
            self._profiling = True
        start = time.time()
        entry = {"phase": name, **meta}
        self._stack.append((name, start, entry))
        try:
            yield entry
        finally:
            _name, start, entry = self._stack.pop()
            elapsed = time.time() - start
            entry["seconds"] = round(elapsed, 3)
            if "items" in entry:
                entry["items_per_sec"] = round(
                    entry["items"] / max(elapsed, 1e-9), 1
                )
            self.phases.append(entry)

    def finish(self, output_dir=None, quiet=False):
        if self._profiling:
            import jax

            jax.profiler.stop_trace()
            self._profiling = False
        if not quiet:
            total = sum(p["seconds"] for p in self.phases)
            sys.stderr.write("\namira-tpu phase timings:\n")
            for p in self.phases:
                rate = (
                    f"  ({p['items_per_sec']:.0f} {p.get('unit', 'items')}/s)"
                    if "items_per_sec" in p
                    else ""
                )
                sys.stderr.write(
                    f"  {p['phase']:<32s} {p['seconds']:8.2f}s{rate}\n"
                )
            sys.stderr.write(f"  {'total':<32s} {total:8.2f}s\n")
        if output_dir is not None:
            with open(os.path.join(output_dir, "phase_timings.json"), "w") as o:
                json.dump(self.phases, o, indent=1)


TIMER = PhaseTimer()


def phase(name: str, **meta):
    return TIMER.phase(name, **meta)
