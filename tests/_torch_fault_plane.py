"""The fault-schedule ``DataPlane`` harness of ``tests/_fault_plane.py``,
bound to the PyTorch port's serving package.

``_fault_plane.py`` is host policy over ``repro.core`` / ``repro.serve``
names looked up when its functions run (``VirtualMemory``, ``Scheduler``,
``RestoreFailure``, ...).  This module loads a second, private copy of
that file and rebinds those names to ``repro_torch``'s, so the port's
scheduler and router run under the very same fault plane, schedules,
token streams and drive loops as the JAX suites (``FaultyDataPlane``,
``make_replica``, ``drive``, ``drive_router``, ``token_for``,
``expected_output``), and ``tests/_fault_plane.py`` stays as it is.
"""

import importlib.util
import pathlib

import repro_torch.core as _core
import repro_torch.serve as _serve

_spec = importlib.util.spec_from_file_location(
    "_torch_fault_plane_impl",
    pathlib.Path(__file__).with_name("_fault_plane.py"))
_impl = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_impl)
for _name in ("PerfCounters", "VirtualMemory", "VMemConfig"):
    setattr(_impl, _name, getattr(_core, _name))
for _name in ("Request", "RestoreFailure", "Scheduler", "ServeConfig"):
    setattr(_impl, _name, getattr(_serve, _name))

FaultyDataPlane = _impl.FaultyDataPlane
drive = _impl.drive
drive_router = _impl.drive_router
expected_output = _impl.expected_output
make_replica = _impl.make_replica
token_for = _impl.token_for

__all__ = ["FaultyDataPlane", "drive", "drive_router", "expected_output",
           "make_replica", "token_for"]
