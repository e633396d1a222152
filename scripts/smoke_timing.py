#!/usr/bin/env python3
"""Runs chip_smoke.py with every module-level function of it timed: each
call that takes a second or more prints ``[timing] <indent><name>: <s>``
when it returns, indented by its depth of nesting, so that a phase's
seconds read as the sum of its parts. Arguments are chip_smoke.py's
(``--phases N,M``). Calls that _beside runs in threads print their
lines as they end, among the others.

    python3 scripts/smoke_timing.py > smoke.log; grep '^\\[timing\\]' smoke.log
"""
import functools
import inspect
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

_DEPTH = [0]
_UNTIMED = ("main", "check", "_say")


def _timed(name, fn):
    @functools.wraps(fn)
    def call(*args, **kwargs):
        _DEPTH[0] += 1
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            dt = time.perf_counter() - t0
            _DEPTH[0] -= 1
            if dt >= 1.0:
                print(f"[timing] {'  ' * _DEPTH[0]}{name}: {dt:.1f} s",
                      flush=True)
    return call


for _name, _fn in list(vars(chip_smoke).items()):
    if inspect.isfunction(_fn) and _fn.__module__ == "chip_smoke" and \
            _name not in _UNTIMED:
        setattr(chip_smoke, _name, _timed(_name, _fn))

if __name__ == "__main__":
    sys.exit(chip_smoke.main(sys.argv[1:]))
