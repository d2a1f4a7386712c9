"""The port's substrate (ray_tpu_torch: exceptions, object_ref, _private's
ids, resources, config, task_spec and serialization) against the JAX
package's, on the CPU: twins of tests/test_ids.py's classes, with the same
inputs through both packages and their outputs held equal, plus the port's
own differences (the GPU slot names, the RAY_TPU_TORCH_ environment prefix,
torch tensors in place of jax arrays)."""

import dataclasses
import pickle

import numpy as np
import pytest
import torch

import ray_tpu.exceptions as jexc
import ray_tpu_torch.exceptions as texc
from ray_tpu._private import config as jconfig
from ray_tpu._private import ids as jids
from ray_tpu._private import resources as jres
from ray_tpu._private import serialization as jser
from ray_tpu._private import task_spec as jspec
from ray_tpu_torch._private import config as tconfig
from ray_tpu_torch._private import ids as tids
from ray_tpu_torch._private import resources as tres
from ray_tpu_torch._private import serialization as tser
from ray_tpu_torch._private import task_spec as tspec
from ray_tpu_torch.object_ref import ObjectRef

_ID_CLASSES = ("UniqueID", "NodeID", "WorkerID", "PlacementGroupID",
               "JobID", "ActorID", "TaskID", "ObjectID")


# ----------------------------------------------------------------- TestIDs


@pytest.mark.parametrize("name", _ID_CLASSES)
def test_id_sizes_and_roundtrip(name):
    cls, jcls = getattr(tids, name), getattr(jids, name)
    assert cls.SIZE == jcls.SIZE
    rid = cls.from_random()
    assert len(rid.binary()) == cls.SIZE
    assert cls.from_hex(rid.hex()) == rid
    assert pickle.loads(pickle.dumps(rid)) == rid
    assert cls.nil().is_nil() and not rid.is_nil()
    assert cls.nil().binary() == jcls.nil().binary()


def test_task_and_object_id_derivations_equal_jax():
    """Lineage hashing gives the JAX package's bytes for the same inputs."""
    out = []
    for m in (tids, jids):
        job = m.JobID.from_int(7)
        driver = m.TaskID.for_driver_task(job)
        t1 = m.TaskID.for_normal_task(job, driver, 1)
        actor = m.ActorID.of(job, driver, 5)
        creation = m.TaskID.for_actor_creation_task(actor)
        at = m.TaskID.for_actor_task(job, driver, 3, actor)
        objs = (m.ObjectID.for_task_return(t1, 1),
                m.ObjectID.for_task_return(t1, 2), m.ObjectID.for_put(t1, 1))
        out.append([x.binary() for x in (job, driver, t1, actor, creation,
                                         at, *objs)])
        assert t1 == m.TaskID.for_normal_task(job, driver, 1)
        assert t1.job_id() == job and actor.job_id() == job
        assert creation.job_id() == job
        assert objs[0].task_id() == t1 and objs[0].index() == 1
        assert objs[2].index() == -1 and objs[2].is_put()
        assert len(set(objs)) == 3
    assert out[0] == out[1]


# ----------------------------------------------------------- TestResources


def test_resource_slots_are_the_jax_slots_renamed_for_the_gpu():
    assert tres.PREDEFINED == ("CPU", "memory", "GPU", "gpu_memory")
    assert jres.PREDEFINED == ("CPU", "memory", "TPU", "tpu_memory")
    assert (tres.CPU, tres.MEM, tres.GPU, tres.GPU_MEM) == (
        jres.CPU, jres.MEM, jres.TPU, jres.TPU_MEM)
    assert tres.KILO == jres.KILO == 1000
    assert tres.NUM_PREDEFINED == jres.NUM_PREDEFINED


_RENAMED = {"GPU": "TPU", "gpu_memory": "tpu_memory", "num_gpus": "TPU"}


@pytest.mark.parametrize("request_", [
    {"CPU": 2, "GPU": 1, "memory": 0.5, "accel": 3},
    {"num_cpus": 1.5, "num_gpus": 0.25, "object_store_memory": 2},
    {"gpu_memory": 4.001, "CPU": 0.001, "slot": 2, "other": 0},
])
def test_from_dict_fills_the_same_columns_as_jax(request_):
    """The same demand, with the accelerator named GPU here and TPU there,
    gives the same fixed-point vector and custom map."""
    rs = tres.ResourceSet.from_dict(request_)
    js = jres.ResourceSet.from_dict(
        {_RENAMED.get(k, k): v for k, v in request_.items()})
    assert rs.predefined.dtype == np.int64
    np.testing.assert_array_equal(rs.predefined, js.predefined)
    assert rs.custom == js.custom
    assert rs.key() == js.key()


def test_gpu_aliases_and_no_tpu_alias():
    d = tres.ResourceSet.from_dict({"CPU": 2, "num_gpus": 1}).to_dict()
    assert d == {"CPU": 2.0, "GPU": 1.0}
    # TPU is an ordinary custom resource in the port, not an alias.
    assert tres.ResourceSet.from_dict({"TPU": 1}).custom == {"TPU": 1000}


def test_subset_fractional_exact_as_jax():
    for m in (tres, jres):
        avail = m.ResourceSet.from_dict({"CPU": 1})
        half = m.ResourceSet.from_dict({"CPU": 0.5})
        rem = avail.subtract(half)
        assert half.is_subset_of(avail) and half.is_subset_of(rem)
        rem2 = rem.subtract(half)
        assert not half.is_subset_of(rem2) and rem2.is_empty()


def test_custom_resources_and_node_accounting_as_jax():
    for m in (tres, jres):
        avail = m.ResourceSet.from_dict({"CPU": 4, "slot": 2})
        assert m.ResourceSet.from_dict({"slot": 1}).is_subset_of(avail)
        assert not m.ResourceSet.from_dict({"slot": 3}).is_subset_of(avail)
        assert not m.ResourceSet.from_dict({"other": 1}).is_subset_of(avail)
        node = m.NodeResources(m.ResourceSet.from_dict({"CPU": 2}))
        one = m.ResourceSet.from_dict({"CPU": 1})
        assert node.acquire(one) and node.acquire(one)
        assert not node.acquire(one)
        node.release(one)
        node.release(one)
        node.release(one)          # clamped at total
        assert node.available == node.total


def test_dense_matrix_and_pg_names_equal_jax():
    sets = [{"CPU": 1}, {"CPU": 2, "slot": 1}, {"memory": 3.5, "slot": 0.5}]
    mt = tres.dense_matrix([tres.ResourceSet.from_dict(s) for s in sets],
                           custom_names=("slot",))
    mj = jres.dense_matrix([jres.ResourceSet.from_dict(s) for s in sets],
                           custom_names=("slot",))
    np.testing.assert_array_equal(mt, mj)
    assert mt.shape == (3, tres.NUM_PREDEFINED + 1)
    bundles = [{"CPU": 1, "GPU": 0}, {"CPU": 2, "memory": 1}]
    assert tres.pg_bundle_grants(bundles, "ab12") == \
        jres.pg_bundle_grants(bundles, "ab12")
    assert tres.translate_pg_demand({"CPU": 1}, "ab12", 1) == \
        jres.translate_pg_demand({"CPU": 1}, "ab12", 1)
    for name in ("CPU_group_3_ab12", "CPU_group_ab12", "CPU", "x_group_"):
        assert tres.parse_pg_resource(name) == jres.parse_pg_resource(name)


# ------------------------------------------------------------ TestTaskSpec


def _spec(m, ids, res, resources=None, fn="mod.f"):
    job = ids.JobID.from_int(1)
    task = ids.TaskID.for_normal_task(job, ids.TaskID.for_driver_task(job), 1)
    return m.TaskSpec(
        task_id=task, job_id=job, task_type=m.TaskType.NORMAL_TASK,
        function=m.FunctionDescriptor("mod", fn),
        args=[("value", 1), ("ref", ids.ObjectID.for_task_return(task, 1))],
        num_returns=2,
        resources=resources or res.ResourceSet.from_dict({"CPU": 1}))


def test_scheduling_class_interning():
    a = _spec(tspec, tids, tres)
    b = _spec(tspec, tids, tres)
    c = _spec(tspec, tids, tres, tres.ResourceSet.from_dict({"CPU": 2}))
    d = _spec(tspec, tids, tres, fn="mod.g")
    assert a.scheduling_class == b.scheduling_class
    assert len({a.scheduling_class, c.scheduling_class,
                d.scheduling_class}) == 3
    assert tspec.scheduling_class_resources(c.scheduling_class) == \
        tres.ResourceSet.from_dict({"CPU": 2})


def test_returns_and_deps_equal_jax():
    t, j = _spec(tspec, tids, tres), _spec(jspec, jids, jres)
    assert [r.binary() for r in t.return_ids()] == \
        [r.binary() for r in j.return_ids()]
    assert [d.binary() for d in t.dependencies()] == \
        [d.binary() for d in j.dependencies()]
    assert len(t.dependencies()) == 1 and t.return_ids()[1].index() == 2
    assert [f.name for f in dataclasses.fields(tspec.TaskSpec)] == \
        [f.name for f in dataclasses.fields(jspec.TaskSpec)]


def test_kwarg_refs_are_dependencies():
    spec = _spec(tspec, tids, tres)
    oid = tids.ObjectID.for_put(spec.task_id, 3)
    spec.metadata["kwargs"] = {"x": ObjectRef(oid), "y": 2}
    assert spec.dependencies()[-1] == oid


# --------------------------------------------------------- object_ref


def test_object_ref_handle_and_no_runtime_yet():
    """The handle's identity and pickling; with no runtime yet, future()
    fails with the JAX package's exception type; once init() has run, a
    put's future() and await resolve."""
    import asyncio

    import ray_tpu
    import ray_tpu_torch
    from ray_tpu.object_ref import ObjectRef as JObjectRef

    oid = tids.ObjectID.for_put(
        tids.TaskID.for_driver_task(tids.JobID.from_int(2)), 1)
    ref = ObjectRef(oid, owner=b"owner")
    back = pickle.loads(pickle.dumps(ref))
    assert back == ref and hash(back) == hash(ref)
    assert back._owner == b"owner" and ref.task_id() == oid.task_id()
    assert ref.hex() == oid.hex() and repr(ref) == f"ObjectRef({oid.hex()})"
    joid = jids.ObjectID(oid.binary())
    with pytest.raises(Exception) as jinfo:
        JObjectRef(joid).future()
    with pytest.raises(type(jinfo.value)):
        ref.future()
    ray_tpu_torch.init(num_cpus=1, num_gpus=0)
    try:
        put = ray_tpu_torch.put(41)
        assert put.future().result(timeout=5) == 41

        async def plus_one():
            return await put + 1

        assert asyncio.run(plus_one()) == 42
    finally:
        ray_tpu_torch.shutdown()
        ray_tpu.shutdown()


# --------------------------------------------------------- TestSerialization


@pytest.mark.parametrize("value", [
    1, "x", [1, 2, {"a": (3, None)}], {"k": b"bytes"}, 2.5, (None, [], {}),
], ids=repr)
def test_python_values_roundtrip_and_cross_decode_with_jax(value):
    """Python values go through either package's context and come back
    equal, also when the other package decodes the bytes."""
    tctx, jctx = tser.get_context(), jser.get_context()
    assert tctx.deserialize(tctx.serialize(value)) == value
    flat = tctx.serialize(value).to_bytes()
    assert jctx.deserialize(jser.SerializedObject.from_bytes(flat)) == value
    flat = jctx.serialize(value).to_bytes()
    assert tctx.deserialize(tser.SerializedObject.from_bytes(flat)) == value


def test_numpy_zero_copy_and_wire_format_equal_jax():
    arr = np.arange(1 << 16, dtype=np.float32)
    ser = tser.get_context().serialize({"w": arr})
    jser_ = jser.get_context().serialize({"w": arr})
    assert len(ser.buffers) == len(jser_.buffers) == 1   # out of band
    assert np.shares_memory(np.asarray(ser.buffers[0].raw()), arr)
    assert ser.to_bytes() == jser_.to_bytes()
    out = tser.get_context().deserialize(ser)
    np.testing.assert_array_equal(out["w"], arr)


def _tensors(seed):
    g = torch.Generator().manual_seed(seed)
    f32 = torch.randn(3, 5, generator=g)
    return {"f32": f32, "bf16": torch.randn(7, generator=g).bfloat16(),
            "i64": torch.arange(-4, 9, dtype=torch.int64)[::2],
            "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 4),
            "transposed": f32.t(), "bool": torch.tensor([True, False])}


@pytest.mark.parametrize("wire", [False, True], ids=["in_process", "bytes"])
def test_cpu_tensors_nested_roundtrip(wire):
    """f32, bf16 (no numpy dtype), int64 and odd layouts, nested in lists
    and dicts, come back with their dtype, shape and bits, on the CPU."""
    ctx = tser.get_context()
    t = _tensors(0)
    value = [t["f32"], {"nested": [t["bf16"], {"i": t["i64"]}]},
             (t["scalar"], t["empty"]), {"tr": t["transposed"],
                                         "b": t["bool"], "n": 7}]
    ser = ctx.serialize(value)
    assert len(ser.buffers) == 7      # every tensor out of band
    if wire:
        ser = tser.SerializedObject.from_bytes(ser.to_bytes())
    out = ctx.deserialize(ser)
    got = [out[0], out[1]["nested"][0], out[1]["nested"][1]["i"], out[2][0],
           out[2][1], out[3]["tr"], out[3]["b"]]
    want = [t[k] for k in ("f32", "bf16", "i64", "scalar", "empty",
                           "transposed", "bool")]
    for g, w in zip(got, want):
        assert g.device.type == "cpu" and g.dtype == w.dtype
        assert g.shape == w.shape and torch.equal(g, w)
    assert out[3]["n"] == 7


def test_cuda_tensor_placeholder_refuses_to_land_on_the_cpu(monkeypatch):
    """A tensor that left a card comes back on a card: without one its
    restore raises, never a silent CPU tensor."""
    ph = tser._TensorPlaceholder("float32", (2,), 0, "cuda")
    buf = pickle.PickleBuffer(np.zeros(2, np.float32).view(np.uint8))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tser._tensor_from(buf, ph)


def test_closure_custom_serializer_and_contained_refs():
    ctx = tser.get_context()
    y = 10
    assert ctx.deserialize(ctx.serialize(lambda x: x + y))(5) == 15

    class Weird:
        def __init__(self, v):
            self.v = v

        def __reduce__(self):
            raise TypeError("not picklable")

    own = tser.SerializationContext()
    own.register_custom_serializer(Weird, lambda w: w.v, lambda v: Weird(v))
    assert own.deserialize(own.serialize([Weird(42)]))[0].v == 42
    oid = tids.ObjectID.for_put(
        tids.TaskID.for_driver_task(tids.JobID.from_int(1)), 2)
    ser = ctx.serialize({"r": ObjectRef(oid)})
    assert ser.contained_refs == [oid.binary()]
    assert ctx.deserialize(ser)["r"] == ObjectRef(oid)


# ------------------------------------------------------------- exceptions

_EXC_ARGS = {
    "RayTpuError": ("boom",),
    "TaskError": ("f", ValueError("bad"), "remote tb"),
    "ActorError": (b"aid", "gone"),
    "ActorDiedError": (b"aid",),
    "ActorUnavailableError": (b"aid", "restarting"),
    "ObjectLostError": ("oid", "lost"),
    "ObjectStoreFullError": ("full",),
    "WorkerCrashedError": ("crash",),
    "NodeDiedError": ("node",),
    "GetTimeoutError": ("late",),
    "TaskCancelledError": ("tid",),
    "TaskTimeoutError": ("tid", 1.5),
    "TaskPoisonedError": (b"\x01\x02", "fn", 3),
    "ActorExitError": (),
    "RuntimeEnvError": ("env",),
    "PlacementGroupError": ("pg",),
    "ClusterUnavailableError": ("down",),
    "ReplicaUnavailableError": ("tag", "no replica"),
}


def test_exception_classes_are_the_jax_packages_18():
    def classes(mod):
        return sorted(n for n, v in vars(mod).items()
                      if isinstance(v, type) and issubclass(v, BaseException)
                      and v.__module__ == mod.__name__)
    assert classes(texc) == classes(jexc) == sorted(_EXC_ARGS)
    assert len(_EXC_ARGS) == 18
    assert texc.__all__ == jexc.__all__


@pytest.mark.parametrize("name", sorted(_EXC_ARGS))
def test_exception_pickles_like_jax(name):
    cls, jcls = getattr(texc, name), getattr(jexc, name)
    assert [b.__name__ for b in cls.__mro__] == \
        [b.__name__ for b in jcls.__mro__]
    err = cls(*_EXC_ARGS[name])
    back = pickle.loads(pickle.dumps(err))
    assert type(back) is cls
    assert str(back) == str(err) == str(jcls(*_EXC_ARGS[name]))
    assert vars(back).keys() == vars(err).keys()
    assert isinstance(back, texc.RayTpuError) == (name != "ActorExitError")


def test_get_timeout_error_is_a_timeout_error():
    assert issubclass(texc.GetTimeoutError, TimeoutError)
    assert not issubclass(texc.ActorExitError, Exception)


# ----------------------------------------------------------------- config


def test_config_reads_its_own_prefix_only(monkeypatch):
    monkeypatch.setenv("RAY_TPU_TORCH_HEARTBEAT_INTERVAL_MS", "250")
    monkeypatch.setenv("RAY_TPU_NUM_HEARTBEATS_TIMEOUT", "99")
    monkeypatch.setenv("RAY_TPU_TORCH_FLIGHT_RECORDER", "0")
    cfg = tconfig.Config()
    assert cfg.heartbeat_interval_ms == 250
    assert cfg.num_heartbeats_timeout == 30        # RAY_TPU_ is not read
    assert cfg.flight_recorder is False
    jcfg = jconfig.Config()
    assert jcfg.heartbeat_interval_ms == 100       # nor RAY_TPU_TORCH_ there
    assert jcfg.num_heartbeats_timeout == 99
    assert tconfig.ENV_PREFIX == "RAY_TPU_TORCH_"


def test_config_defaults_are_the_jax_packages_but_the_backend():
    t, j = tconfig.Config(), jconfig.Config()
    names = [f.name for f in dataclasses.fields(t)]
    assert names == [f.name for f in dataclasses.fields(j)]
    assert t.scheduler_backend == "torch" and j.scheduler_backend == "jax"
    for n in names:
        if n not in ("scheduler_backend", "_overrides"):
            assert getattr(t, n) == getattr(j, n), n
    cfg = tconfig.reset_config({"scheduler_backend": "scalar"})
    assert tconfig.get_config() is cfg and cfg.scheduler_backend == "scalar"
    with pytest.raises(ValueError, match="Unknown config key"):
        cfg.update({"nope": 1})
    tconfig.reset_config()
