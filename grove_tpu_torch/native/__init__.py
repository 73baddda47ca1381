"""Native (host C++) components, loaded through ctypes.

  serial_scorer.cpp -- the serial solve and the engine's exact repair in
                       C++ (the counterpart of grove_tpu/native/).
  build.py          -- g++ build at first use into build/grove_tpu_torch/;
                       a failed build or an ABI mismatch raises.
  serial_native.py  -- `solve_serial_native` and `repair_native`.
"""

from .serial_native import repair_native, solve_serial_native

__all__ = ["repair_native", "solve_serial_native"]
