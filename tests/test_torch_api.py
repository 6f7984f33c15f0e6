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
