"""PyTorch port, public surface: every public name of gpujpeg_tpu and every
public method of its Encoder and Decoder exists in gpujpeg_tpu_torch, with
the same static-ness and parameter names, and none is a stub any more
(STUBS, the methods the port did not have yet, is empty since the session
surface was ported).  No frames: cheap."""

import inspect
import re
import types

import pytest

import gpujpeg_tpu as gj

import gpujpeg_tpu_torch as gt
from tests import torch_threads  # noqa: F401

#: public names of the JAX package, submodules aside
NAMES = sorted(n for n in dir(gj) if not n.startswith("_")
               and not isinstance(getattr(gj, n), types.ModuleType))

#: public methods of the JAX sessions
METHODS = [(cls, n) for cls in ("Encoder", "Decoder")
           for n in sorted(vars(getattr(gj, cls))) if not n.startswith("_")
           and callable(getattr(getattr(gj, cls), n))]

#: (session, method) -> the ROADMAP queue 1 item of an unported method
STUBS = {}


def test_names_and_methods_listed():
    """The cases below cover the JAX package's whole public surface: 13
    names, 12 methods a session, none of them a stub."""
    assert len(NAMES) == 13 and "default_parameters" in NAMES
    assert len(METHODS) == 24
    assert STUBS == {}


@pytest.mark.parametrize("name", NAMES)
def test_port_exports_name(name):
    """F1: the port exports every public name of the JAX package, of the
    same kind (class, function or value)."""
    assert hasattr(gt, name), name
    ref, got = getattr(gj, name), getattr(gt, name)
    assert isinstance(got, type) == isinstance(ref, type)
    assert callable(got) == callable(ref)
    if not callable(ref):
        assert got == ref


def _params(fn):
    return [p.name for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("cls,name", METHODS,
                         ids=[f"{c}.{n}" for c, n in METHODS])
def test_port_session_method(cls, name):
    """F2: the port's session has the method, static on both sides or on
    neither, with the same parameter names; an unported one (in STUBS)
    would raise NotImplementedError naming its item, never
    AttributeError."""
    ref_cls, got_cls = getattr(gj, cls), getattr(gt, cls)
    assert hasattr(got_cls, name), f"{cls}.{name}"
    static = isinstance(inspect.getattr_static(ref_cls, name), staticmethod)
    assert isinstance(inspect.getattr_static(got_cls, name),
                      staticmethod) == static
    ref_fn, got_fn = getattr(ref_cls, name), getattr(got_cls, name)
    assert _params(got_fn) == _params(ref_fn)
    item = STUBS.get((cls, name))
    if item is None:
        return
    target = got_fn if static else getattr(got_cls(device="cpu"), name)
    args = [None] * len(inspect.signature(target).parameters)
    with pytest.raises(NotImplementedError) as e:
        target(*args)
    assert f"{cls}.{name}" in str(e.value)
    assert {int(m) for m in re.findall(r"item (\d+)", str(e.value))} == {
        item}


def test_encode_to_device_arity():
    """F3: encode_to_device returns (geo, res, meta) like the JAX method,
    meta None under check=False on both sides."""
    import numpy as np

    frame = np.zeros((16, 16, 3), np.uint8)
    ref = gj.Encoder().encode_to_device(frame, gj.Parameters(
        restart_interval=8))
    got = gt.Encoder(device="cpu").encode_to_device(frame, gt.Parameters(
        restart_interval=8))
    assert len(got) == len(ref) == 3
    assert got[0].segment_count == ref[0].segment_count
    assert (got[2] is None) == (ref[2] is None) is False
    ref = gj.Encoder().encode_to_device(frame, gj.Parameters(
        restart_interval=8), check=False)
    got = gt.Encoder(device="cpu").encode_to_device(frame, gt.Parameters(
        restart_interval=8), check=False)
    assert len(got) == len(ref) == 3 and got[2] is None and ref[2] is None


def _defined(mod):
    """Public functions and classes a module defines itself."""
    return {n: v for n, v in vars(mod).items() if not n.startswith("_")
            and callable(v) and getattr(v, "__module__", None)
            == mod.__name__}


@pytest.mark.parametrize("sub", ["mesh", "batch", "dist"])
def test_parallel_names(sub):
    """gpujpeg_tpu_torch.parallel.<sub> defines every public function
    and class of gpujpeg_tpu.parallel.<sub> (Mesh, which the JAX module
    imports, included), each function taking the JAX parameters first
    and in order, each class every public method of the JAX class with
    its parameters."""
    import importlib

    ref = importlib.import_module(f"gpujpeg_tpu.parallel.{sub}")
    got = importlib.import_module(f"gpujpeg_tpu_torch.parallel.{sub}")
    want = _defined(ref)
    if sub == "mesh":
        want["Mesh"] = ref.Mesh
    assert want and set(want) <= set(vars(got)), set(want) - set(vars(got))
    for name, obj in want.items():
        port = getattr(got, name)
        assert isinstance(port, type) == isinstance(obj, type), name
        if not isinstance(obj, type):
            p = _params(obj)
            assert _params(port)[:len(p)] == p, name
            continue
        if sub == "mesh":
            continue
        for m, fn in vars(obj).items():
            if m.startswith("_") or not callable(fn):
                continue
            p = _params(fn)
            assert _params(getattr(port, m))[:len(p)] == p, f"{name}.{m}"
