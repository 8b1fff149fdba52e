"""The eager JAX training steps that the port's step tests hold the port
against, each built once per test session and shared by the modules and
the pytest-xdist workers through a file under the session's temporary root.

``dense_step`` is the flagship step and the hit-ray step
(``tests/test_torch_train.py``, ``tests/test_torch_hit_rays.py``);
``lever_step`` is the recommended profile's step
(``tests/test_torch_levers.py``); ``nerf_steps`` are the NeRF trainer's
and the flagship's grid-free results (``tests/test_torch_nerf.py``). When
the session holds tests of several, the first process that needs any
builds all of them, one right after the other, so that JAX compiles the
eager primitives the steps share once (~72 s for the lever step instead
of ~200 s in a process of its own). A session of one side builds only its
own.

``shared_dir`` does the same for a directory of files, such as a scene
exported in the DTU layout (``tests/test_torch_datasets.py``,
``tests/test_torch_main.py``).
"""

import os
import pickle

from filelock import FileLock

_DENSE_MODULES = ("test_torch_train", "test_torch_hit_rays")
_LEVER_MODULES = ("test_torch_levers",)
_NERF_MODULES = ("test_torch_nerf",)


def _session_root(tmp_path_factory):
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent  # shared by the workers of this session
    return root


def shared_across_workers(tmp_path_factory, name: str, make):
    """``make()`` once per test session, its (picklable) result shared by
    the modules and the pytest-xdist workers through a file under the
    session's temporary root, the first to take the lock building it
    (pytest-xdist's documented pattern)."""
    path = _session_root(tmp_path_factory) / f"{name}.pkl"
    with FileLock(str(path) + ".lock"):
        if path.is_file():
            return pickle.loads(path.read_bytes())
        data = make()
        path.write_bytes(pickle.dumps(data))
    return data


def shared_dir(tmp_path_factory, name: str, write) -> str:
    """The path of a directory that ``write(path)`` fills once per test
    session, under the session's temporary root, shared like
    :func:`shared_across_workers`."""
    path = _session_root(tmp_path_factory) / name
    with FileLock(str(path) + ".lock"):
        if not (path / ".written").is_file():
            write(str(path))
            (path / ".written").touch()
    return str(path)


def _session_runs(request, modules) -> bool:
    """Whether the session collected a test of one of ``modules`` (every
    pytest-xdist worker collects the whole session)."""
    return any(getattr(getattr(item, "module", None), "__name__", None) in modules
               for item in request.session.items)


def dense_step(request, tmp_path_factory):
    from test_torch_train import _step, make_reels

    def make():
        data = _step(make_reels())
        if _session_runs(request, _LEVER_MODULES):
            _lever_only(tmp_path_factory)
        if _session_runs(request, _NERF_MODULES):
            _nerf_only(tmp_path_factory)
        return data

    return shared_across_workers(tmp_path_factory, "torch_train_step", make)


def lever_step(request, tmp_path_factory):
    if _session_runs(request, _DENSE_MODULES):
        dense_step(request, tmp_path_factory)  # builds the lever step right after
    return _lever_only(tmp_path_factory)


def _lever_only(tmp_path_factory):
    from test_torch_levers import _profile_step

    return shared_across_workers(tmp_path_factory, "torch_lever_step", _profile_step)


def nerf_steps(request, tmp_path_factory):
    if _session_runs(request, _DENSE_MODULES):
        dense_step(request, tmp_path_factory)  # builds the NeRF steps right after
    return _nerf_only(tmp_path_factory)


def _nerf_only(tmp_path_factory):
    from test_torch_nerf import _nerf_steps

    return shared_across_workers(tmp_path_factory, "torch_nerf_steps", _nerf_steps)
