"""The port's public functions take every call that is valid against the JAX
package: each parameter the JAX package names, in its order, binds to the
same name in the port.

The stated exceptions: ``parallel/halo.py`` works on a list of bands where
the JAX package works on a shard inside ``shard_map`` (``axis_name``).  The
JAX package's relay workarounds (``packed=``, ``sharding=``,
``pack_transfer=``, ``pack=``, ``pad_to_full=``, ``batch --pack-transfer``)
bind at their defaults and are refused at any other value, as is a
``shifted`` callback for ``claim_candidates``.  Inputs are made with numpy
from a seed; labels and flags are compared exactly.
"""

import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import particle_col_image_segmentation_tpu as jax_pkg
import particle_col_image_segmentation_tpu_torch as port_pkg
from particle_col_image_segmentation_tpu_torch.config import AnalysisConfig
from particle_col_image_segmentation_tpu_torch.io.loader import batched_device_iterator
from particle_col_image_segmentation_tpu_torch.models import batch as torch_batch
from particle_col_image_segmentation_tpu_torch.parallel import make_mesh
from particle_col_image_segmentation_tpu_torch.utils import profiling

jax_ws = importlib.import_module("particle_col_image_segmentation_tpu.ops.watershed")
ws = importlib.import_module("particle_col_image_segmentation_tpu_torch.ops.watershed")

# (module path under the package, function): the design differences kept
DESIGN_DIFFERENCES = {("parallel.halo", "exchange_rows"), ("parallel.halo", "pad_with_halo")}


def _shared_functions():
    """(module, name, JAX function, port function) for every public function
    that a port module and the JAX module of the same path both define."""
    out = []
    for info in pkgutil.walk_packages(port_pkg.__path__, port_pkg.__name__ + "."):
        rel = info.name[len(port_pkg.__name__) + 1:]
        if rel.endswith("__main__"):
            continue
        try:
            jmod = importlib.import_module(f"{jax_pkg.__name__}.{rel}")
        except ImportError:
            continue
        tmod = importlib.import_module(info.name)
        for name, tf in vars(tmod).items():
            jf = getattr(jmod, name, None)
            if (name.startswith("_") or not inspect.isfunction(tf) or not inspect.isfunction(jf)
                    or tf.__module__ != tmod.__name__ or jf.__module__ != jmod.__name__):
                continue
            out.append((rel, name, jf, tf))
    return out


def _binding_faults(jf, tf) -> list:
    """JAX parameters the port's signature does not take the same way."""
    js, ts = inspect.signature(jf), inspect.signature(tf)
    tpos = [p for p in ts.parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    faults = []
    for i, p in enumerate(js.parameters.values()):
        if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
            continue
        if p.kind == p.KEYWORD_ONLY:
            q = ts.parameters.get(p.name)
            ok = q is not None and q.kind != q.POSITIONAL_ONLY
        else:
            q = tpos[i] if i < len(tpos) else None
            ok = q is not None and q.name == p.name
        if ok and p.default is not p.empty and q.default is q.empty:
            ok = False  # the JAX call may leave it out
        if not ok:
            faults.append(p.name)
    faults += [f"port requires {q.name}" for q in ts.parameters.values()
               if q.name not in js.parameters and q.default is q.empty
               and q.kind not in (q.VAR_POSITIONAL, q.VAR_KEYWORD)]
    return faults


def test_every_shared_public_function_binds_jax_calls():
    shared = _shared_functions()
    assert len(shared) > 60  # the walk found the packages' functions
    faults = {(rel, name): _binding_faults(jf, tf) for rel, name, jf, tf in shared}
    faults = {k: v for k, v in faults.items() if v}
    assert set(faults) == DESIGN_DIFFERENCES, faults


def _levels(seed: int):
    """A 48² relief of levels {0, 1, 2} with 6 markers (plateaus: phase 2
    decides by level distance, where the tunnel would differ)."""
    rng = np.random.default_rng(seed)
    img = _upsample4(rng.integers(0, 3, (12, 12)).astype(np.float32) / 2)
    mk = np.zeros((48, 48), np.int32)
    for i, (r, c) in enumerate(rng.integers(0, 48, (6, 2)), 1):
        mk[r, c] = i
    return img, mk


def _upsample4(x):
    """Each pixel of x as a 4×4 block."""
    return np.kron(x, np.ones((4, 4), np.float32))


@pytest.mark.parametrize("seed", range(4))
def test_watershed_auto_positional_jax_call_matches_jax(seed):
    """``watershed_auto(img, markers, None, 1, True, 1024, 16)``: the seventh
    argument is ``max_sweeps`` in both packages (once, the port's
    ``tunnel_basins``), so the labels and the flag equal JAX's."""
    img, mk = _levels(seed)
    got, gconv = ws.watershed_auto(torch.from_numpy(img), torch.from_numpy(mk), None, 1,
                                   True, 1024, 16)
    want, wconv = jax_ws.watershed_auto(jnp.asarray(img), jnp.asarray(mk), None, 1, True,
                                        1024, 16)
    assert bool(gconv) and bool(wconv)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tunnelled = ws.watershed_auto(torch.from_numpy(img), torch.from_numpy(mk),
                                  tunnel_basins=True)
    assert (tunnelled != got).any()  # the fixture tells the two floods apart
    with pytest.raises(TypeError):
        ws.watershed_auto(torch.from_numpy(img), torch.from_numpy(mk), None, 1, True, 1024,
                          16, True)


def test_claim_candidates_binds_inc_and_seg_where_jax_does():
    rng = np.random.default_rng(1)
    state = [rng.random((16, 16)).astype(np.float32) for _ in range(2)]
    lab = rng.integers(1, 4, (16, 16)).astype(np.int32)
    dist = rng.integers(0, 5, (16, 16)).astype(np.int32)
    eimg = rng.random((16, 16)).astype(np.float32)
    seg = rng.integers(0, 20, (16, 16)).astype(np.int32)
    inc = rng.integers(0, 2, (16, 16)).astype(np.int32)
    args = state + [lab, dist, eimg]
    got = ws.claim_candidates(*map(torch.from_numpy, args), 1, 0, None,
                              torch.from_numpy(inc), torch.from_numpy(seg))
    want = jax_ws.claim_candidates(*map(jnp.asarray, args), 1, 0, jax_ws._shifted,
                                   jnp.asarray(inc), jnp.asarray(seg))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="no shifted callback"):
        ws.claim_candidates(*map(torch.from_numpy, args), 1, 0, jax_ws._shifted)


def _relay_calls():
    planes = torch.zeros((2, 8, 8), dtype=torch.uint8)
    cfg = AnalysisConfig()
    mesh = make_mesh(devices=["cpu"])

    def iterate(**kw):
        return next(batched_device_iterator(lambda p: np.zeros((8, 8), np.uint8), ["a"], 1,
                                            devices=["cpu"], **kw))

    def batch(**kw):
        return list(torch_batch.run_batch([], None, device="cpu", **kw))

    return {
        "fused_segment_batch-packed": (
            lambda v: torch_batch.fused_segment_batch(planes, cfg, 2, (1,), v), False, True),
        "make_fused_segment_fn-packed": (
            lambda v: torch_batch.make_fused_segment_fn(mesh, cfg, 2, (1,), v), False, True),
        "run_batch-sharding": (lambda v: batch(sharding=v), None, object()),
        "run_batch-pack_transfer": (lambda v: batch(pack_transfer=v), False, True),
        "batched_device_iterator-sharding": (lambda v: iterate(sharding=v), None, object()),
        "batched_device_iterator-pad_to_full": (lambda v: iterate(pad_to_full=v), True, False),
        "batched_device_iterator-pack": (lambda v: iterate(pack=v), False, True),
    }


@pytest.mark.parametrize("case", list(_relay_calls()))
def test_relay_arguments_bind_at_their_default_and_are_refused_otherwise(case):
    call, default, other = _relay_calls()[case]
    call(default)
    with pytest.raises(ValueError, match="relay workarounds"):
        call(other)


def test_stage_takes_jax_arguments_and_times_on_the_card_where_there_is_one(monkeypatch):
    """``stage`` binds the JAX package's (name, megapixels) and times on the
    host alone: it synchronises no card, records no CUDA event, and keeps
    its span only after ``enable``, as host seconds in ``STAGE_TOTALS``."""
    def no_card(*_, **__):
        raise AssertionError("the tracer touched the card")

    monkeypatch.setattr(torch.cuda, "synchronize", no_card)
    monkeypatch.setattr(torch.cuda, "Event", no_card)
    monkeypatch.setattr(torch.cuda, "current_stream", no_card)
    inspect.signature(profiling.stage).bind("signature-test", 1.0)
    profiling.reset()
    try:
        with profiling.stage("signature-test", 1.0):
            pass
        assert "signature-test" not in profiling.STAGE_TOTALS
        profiling.enable()
        with profiling.stage("signature-test", megapixels=1.0):
            pass
        assert profiling.STAGE_TOTALS["signature-test"] >= 0
        assert [s.name for s in profiling.records()] == ["signature-test"]
    finally:
        profiling.disable()
        profiling.reset()
