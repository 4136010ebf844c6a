"""The port's device model against the reference's, and its MIG layer.

Parity (exact equality; the stated differences are the resource prefix,
``nvidia.com`` for ``google.com``, the device name ``gpu`` for ``tpu``,
the UUID format, ``GPU-`` for ``TPU-``, the device node ``/dev/nvidia<i>``
for ``/dev/accel<i>`` and the generation name): ``AnnotatedID`` and the
``Chips`` set operations, the mesh arithmetic on the same 1-D bounds,
resource patterns, names and discovery, and ``new_chip_map`` under
``none`` on equal hosts. Port only: the MIG table, placements and plans,
the ``single`` / ``mixed`` chip maps over a fake ``h100-8`` with MIG
layouts, the generation table the roofline reads, and the factory's
no-fallback rule.
"""

from __future__ import annotations

import dataclasses

import pytest

from k8s_gpu_device_plugin_torch.device import chip as tchip
from k8s_gpu_device_plugin_torch.device import slices as tslices
from k8s_gpu_device_plugin_torch.device import topology as ttopo
from k8s_gpu_device_plugin_torch.device.chip_map import new_chip_map as t_new_chip_map
from k8s_gpu_device_plugin_torch.device.factory import make_backend
from k8s_gpu_device_plugin_torch.device.fake import FakeBackend as TFake
from k8s_gpu_device_plugin_torch.resource import naming as tnaming
from k8s_gpu_device_plugin_torch.resource import discover_resources as t_discover
from k8s_gpu_device_plugin_tpu.device import chip as rchip
from k8s_gpu_device_plugin_tpu.device import topology as rtopo
from k8s_gpu_device_plugin_tpu.device.chip_map import new_chip_map as r_new_chip_map
from k8s_gpu_device_plugin_tpu.device.fake import FakeBackend as RFake
from k8s_gpu_device_plugin_tpu.resource import naming as rnaming
from k8s_gpu_device_plugin_tpu.resource import discover_resources as r_discover


def _chips(mod, n=5):
    return [mod.Chip(id=f"id{i}", index=(i * 3) % n, paths=(f"/dev/x{i}", "/dev/common"),
                     coords=((i,),), generation="g", total_memory=1 << 30,
                     numa_node=i % 2,
                     health=mod.HEALTHY if i % 3 else mod.UNHEALTHY)
            for i in range(n)]


# --- chip.py ---------------------------------------------------------------


@pytest.mark.parametrize("s", ["a::0", "a::12", "a::b::3", "::1", "a::", "a",
                               "a::x", "GPU-1::7", ""])
def test_annotated_id_matches_reference(s):
    assert tchip.AnnotatedID.is_annotated(s) == rchip.AnnotatedID.is_annotated(s)
    if rchip.AnnotatedID.is_annotated(s):
        r, t = rchip.AnnotatedID.parse(s), tchip.AnnotatedID.parse(s)
        assert (t.device_id, t.replica, str(t)) == (r.device_id, r.replica, str(r))
    else:
        with pytest.raises(ValueError):
            tchip.AnnotatedID.parse(s)
    ids = [s, "x::1"]
    assert tchip.AnnotatedID.any_annotated(ids) == rchip.AnnotatedID.any_annotated(ids)


def test_chips_set_operations_match_reference():
    r, t = rchip.Chips.of(_chips(rchip)), tchip.Chips.of(_chips(tchip))
    assert t.ids() == r.ids() and t.indices() == r.indices()
    assert t.all_paths() == r.all_paths()
    assert sorted(t.healthy()) == sorted(r.healthy())
    assert t.contains("id1", "id2") == r.contains("id1", "id2")
    assert t.contains("id1", "nope") == r.contains("id1", "nope")
    assert t.get_by_index(3).id == r.get_by_index(3).id
    assert t.get_by_index(99) is None and r.get_by_index(99) is None
    assert t.get_by_id("id4").index == r.get_by_id("id4").index
    sub = ["id0", "id3", "gone"]
    assert sorted(t.subset(sub)) == sorted(r.subset(sub))
    assert sorted(t.difference(t.subset(sub))) == sorted(r.difference(r.subset(sub)))
    assert [c.id for c in t.iter_sorted()] == [c.id for c in r.iter_sorted()]
    assert t.aligned_allocation_supported() == r.aligned_allocation_supported()
    shared = {"a::0": None, "a::1": None, "b": None, "c::0": None}
    rs = rchip.Chips({k: r["id0"] for k in shared})
    ts = tchip.Chips({k: t["id0"] for k in shared})
    assert ts.physical_ids() == rs.physical_ids()
    carved = dataclasses.replace(t["id0"], slice_profile="1g.10gb")
    assert carved.is_slice and not tchip.Chips.of([carved]).aligned_allocation_supported()
    assert t["id0"].with_health(tchip.UNKNOWN).health == "Unknown"
    assert (tchip.HEALTHY, tchip.UNHEALTHY, tchip.UNKNOWN) == \
        (rchip.HEALTHY, rchip.UNHEALTHY, rchip.UNKNOWN)


# --- topology.py -----------------------------------------------------------


@pytest.mark.parametrize("n,dims", [(1, 1), (8, 1), (12, 2), (16, 2), (18, 3),
                                    (64, 3), (7, 2), (36, 2)])
def test_factorize_matches_reference(n, dims):
    assert ttopo._factorize(n, dims) == rtopo._factorize(n, dims)


def _pair(n: int, slice_bounds=None, offset=()):
    """The same 1-D host in both models (the reference's on a v5e row)."""
    r = rtopo.HostTopology(rtopo.GENERATIONS["v5e"], (n,), slice_bounds, offset,
                           (False,))
    t = ttopo.HostTopology(ttopo.GENERATIONS["h100"], (n,), slice_bounds, offset,
                           (False,))
    return r, t


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_arithmetic_matches_reference_on_1d_bounds(n):
    r, t = _pair(n)
    assert t.coords() == r.coords() == [(i,) for i in range(n)]
    assert t.num_chips == r.num_chips and t.host_grid == r.host_grid
    assert t.worker_index == r.worker_index and t.is_multihost == r.is_multihost
    for c in r.coords():
        assert t.index_of(c) == r.index_of(c)
        assert t.neighbors(c) == r.neighbors(c)
        assert t.global_coord(c) == r.global_coord(c)
    assert ttopo.parse_topology(f"h100-{n}").bounds == (n,)
    assert ttopo.parse_topology(f"h100-{n}").wraparound == (False,)


@pytest.mark.parametrize("hosts,worker", [(1, 0), (2, 1), (4, 0), (4, 3)])
def test_as_slice_member_matches_reference(hosts, worker, monkeypatch):
    # the reference parses its group spec into its generation's 2-D mesh:
    # hand both the same 1-D group instead
    r_host, t_host = _pair(8)
    monkeypatch.setattr(rtopo, "parse_topology",
                        lambda spec: _pair(8 * hosts)[0])
    r = rtopo.as_slice_member(r_host, "v5e-x", worker)
    t = ttopo.as_slice_member(t_host, f"h100-{8 * hosts}", worker)
    assert (t.bounds, t.slice_bounds, t.host_offset, t.wraparound) == \
        (r.bounds, r.slice_bounds, r.host_offset, r.wraparound)
    assert (t.worker_index, t.host_grid, t.num_hosts, t.is_multihost) == \
        (r.worker_index, r.host_grid, r.num_hosts, r.is_multihost)
    assert t.global_coord((3,)) == r.global_coord((3,))
    with pytest.raises(ValueError):
        ttopo.as_slice_member(t_host, f"h100-{8 * hosts}", hosts)
    with pytest.raises(ValueError):
        ttopo.as_slice_member(t_host, "h100-12", 0)  # does not tile


def test_parse_topology_and_generation_names():
    with pytest.raises(ValueError):
        ttopo.parse_topology("v5e-4")  # no TPU row is carried over
    with pytest.raises(ValueError):
        ttopo.parse_topology("h100-0")
    with pytest.raises(ValueError):
        ttopo.parse_topology("h100")
    assert ttopo.generation_for_device_kind("NVIDIA H100 80GB HBM3") == "h100"
    assert ttopo.generation_for_device_kind("h100") == "h100"
    assert ttopo.generation_for_device_kind("NVIDIA H100 PCIe") is None
    assert ttopo.generation_for_device_kind("cpu") is None


def test_generation_table_is_the_rooflines():
    from k8s_gpu_device_plugin_torch.metrics import roofline

    h100 = ttopo.GENERATIONS["h100"]
    assert (h100.hbm_bytes, h100.peak_bf16_tflops, h100.hbm_bandwidth_gbps,
            h100.pci_device_id) == (80 * 1024**3, 989.4, 3352.0, 0x2330)
    card = roofline.CARDS[h100.device_name]
    assert (card.peak_bf16_tflops, card.hbm_gbps) == (989.4, 3352.0)
    assert roofline.CARDS[roofline.OFF_DEVICE_CARD] is card


# --- resource/ -------------------------------------------------------------


@pytest.mark.parametrize("pattern,name", [
    ("*", "h100"), ("*", "v5e"), ("h1*", "h100"), ("v5?", "v5e"),
    ("h100", "h1000"), ("[gh]100", "h100"), ("1g.*", "1g.10gb"),
    ("3g.40gb", "3g.40gbx"), ("*.10gb", "1g.10gb"), ("", "")])
def test_resource_pattern_matches_reference(pattern, name):
    assert tnaming.ResourcePattern(pattern).matches(name) == \
        rnaming.ResourcePattern(pattern).matches(name)


@pytest.mark.parametrize("name", ["gpu", "tpu", "x/y", "a" * 50, "a" * 60,
                                  "vendor/" + "b" * 57, "vendor/", "/b",
                                  "mig-1g.10gb"])
def test_resource_names_match_reference(name):
    def outcome(naming):
        try:
            res = naming.Resource.new("*", name)
        except ValueError:
            return "refused"
        return res.name.split_name()[1], res.name.is_shared, \
            res.name.shared().is_shared, len(res.name)

    r, t = outcome(rnaming), outcome(tnaming)
    if r == "refused" or t == "refused":
        # the prefixes differ in length by one: the same names refused
        # (the 63-character limit) save where that one character decides
        assert r == t or len(name) + len(tnaming.RESOURCE_PREFIX) + 1 == 64
    else:
        assert t[:3] == r[:3]
        assert t[3] - r[3] == len(tnaming.RESOURCE_PREFIX) - len(rnaming.RESOURCE_PREFIX) \
            if "/" not in name else t[3] == r[3]
    assert tnaming.RESOURCE_PREFIX == "nvidia.com"
    assert tnaming.MAX_RESOURCE_NAME_LENGTH == rnaming.MAX_RESOURCE_NAME_LENGTH == 63
    assert tnaming.SHARED_SUFFIX == rnaming.SHARED_SUFFIX


@pytest.mark.parametrize("strategy", ["none", "single"])
def test_discover_resources_matches_reference(strategy):
    r = r_discover(strategy, rtopo.parse_topology("v5e-4"))
    t = t_discover(strategy, ttopo.parse_topology("h100-4"))
    assert [(str(x.pattern), x.name.split_name()[1]) for x in t] == \
        [(str(x.pattern), x.name.split_name()[1].replace("tpu", "gpu")) for x in r]
    assert [str(x.name) for x in t] == ["nvidia.com/gpu"]


def test_discover_resources_mixed_names_mig_profiles():
    topo = ttopo.parse_topology("h100-8")
    got = t_discover("mixed", topo, "1g.10gb,3g.40gb,1g.10gb")
    assert [(str(r.pattern), str(r.name)) for r in got] == [
        ("1g.10gb", "nvidia.com/mig-1g.10gb"),
        ("3g.40gb", "nvidia.com/mig-3g.40gb"),
        ("h100", "nvidia.com/gpu")]
    assert [str(r.name) for r in t_discover("mixed", topo)] == [
        "nvidia.com/mig-3g.40gb", "nvidia.com/gpu"]
    with pytest.raises(ValueError):
        t_discover("mixed")  # no topology and no plan
    with pytest.raises(ValueError):
        t_discover("mixed", topo, "2x2")


# --- chip_map.py under none ------------------------------------------------


@pytest.mark.parametrize("replicas", [0, 3])
@pytest.mark.parametrize("n", [1, 4, 8])
def test_none_chip_map_matches_reference(n, replicas):
    r_topo = rtopo.HostTopology(rtopo.GENERATIONS["v5e"], (n,), wraparound=(False,))
    rb, tb = RFake(r_topo), TFake(f"h100-{n}")
    rb.set_unhealthy(0)
    tb.set_unhealthy(0)
    r = r_new_chip_map(rb, r_discover("none"), "none", shared_replicas=replicas)
    t = t_new_chip_map(tb, t_discover("none"), "none", shared_replicas=replicas)
    assert list(t) == ["nvidia.com/gpu"] and list(r) == ["google.com/tpu"]
    rc, tc = r["google.com/tpu"], t["nvidia.com/gpu"]
    assert t.total_devices() == r.total_devices() == n * max(1, replicas)

    def shape(chips, prefix):
        return [(c.id.replace(prefix, "X", 1)[:1], c.id.rpartition("::")[2]
                 if replicas else "", c.index, c.coords, c.numa_node,
                 c.health, c.replicas, c.slice_profile, c.chip_indices,
                 c.paths[0].rstrip("0123456789"))
                for c in chips.iter_sorted()]

    got = [s[:-1] for s in shape(tc, "GPU-")]
    want = [s[:-1] for s in shape(rc, "TPU-")]
    assert got == want
    assert {s[-1] for s in shape(tc, "GPU-")} == {"/dev/nvidia"}
    assert all(c.id.startswith("GPU-") for c in tc.values())
    assert tc.physical_ids() == [
        c.uuid for c in tb.enumerate_chips()] if replicas == 0 else True
    assert len(tc.physical_ids()) == len(rc.physical_ids()) == n
    assert tc.aligned_allocation_supported() == rc.aligned_allocation_supported()


# --- MIG ---------------------------------------------------------------------

MIG_TABLE = {  # NVIDIA's MIG User Guide, H100 80GB
    "1g.10gb": (0, 1, 2, 3, 4, 5, 6),
    "1g.20gb": (0, 2, 4, 6),
    "2g.20gb": (0, 2, 4),
    "3g.40gb": (0, 4),
    "4g.40gb": (0,),
    "7g.80gb": (0,),
}


def test_mig_placements_are_the_guides_table():
    topo = ttopo.parse_topology("h100-2")
    assert [p.name for p in tslices.supported_profiles(topo)] == [
        "1g.10gb", "1g.20gb", "2g.20gb", "3g.40gb", "4g.40gb", "7g.80gb"]
    for name, starts in MIG_TABLE.items():
        profile = tslices.SliceProfile.parse(name)
        placements = tslices.enumerate_placements(topo, profile)
        assert [(p.gpu, p.start) for p in placements] == [
            (g, s) for g in range(2) for s in starts]
        assert all(p.chip_indices(topo) == [p.gpu] for p in placements)
    with pytest.raises(ValueError):
        tslices.SliceProfile.parse("2x2")


@pytest.mark.parametrize("name,per_gpu", [("1g.10gb", 7), ("1g.20gb", 4),
                                          ("2g.20gb", 3), ("3g.40gb", 2),
                                          ("4g.40gb", 1), ("7g.80gb", 1)])
def test_uniform_plan_fills_every_gpu(name, per_gpu):
    topo = ttopo.parse_topology("h100-8")
    profile = tslices.SliceProfile.parse(name)
    plan = tslices.uniform_plan(topo, profile)
    assert len(plan) == 8 * per_gpu
    placed = tslices.partition_host(topo, plan)
    assert [sum(p.gpu == g for p in placed) for g in range(8)] == [per_gpu] * 8
    with pytest.raises(ValueError):
        tslices.partition_host(topo, plan + [profile])


def _disjoint(placed):
    for g in {p.gpu for p in placed}:
        mine = [p for p in placed if p.gpu == g]
        slots = [s for p in mine for s in p.slots()]
        assert len(slots) == len(set(slots)) and max(slots) < 8
        assert sum(p.profile.compute for p in mine) <= 7
        assert all(p.start in p.profile.starts for p in mine)


def test_every_single_gpu_plan_that_fits_packs():
    """Exhaustive over multisets of profiles on one GPU: partition_host
    packs exactly the plans a brute force over start slots can place."""
    import itertools

    topo = ttopo.parse_topology("h100-1")
    names = list(MIG_TABLE)

    def brute(plan):
        def go(i, used, compute):
            if i == len(plan):
                return True
            p = tslices.H100_PROFILES[plan[i]]
            for s in p.starts:
                mask = ((1 << p.size) - 1) << s
                if not used & mask and compute + p.compute <= 7 and \
                        go(i + 1, used | mask, compute + p.compute):
                    return True
            return False
        return go(0, 0, 0)

    fits = 0
    for k in range(1, 8):
        for plan in itertools.combinations_with_replacement(names, k):
            profiles = [tslices.SliceProfile.parse(n) for n in plan]
            if brute(plan):
                fits += 1
                _disjoint(tslices.partition_host(topo, profiles))
            else:
                with pytest.raises(ValueError, match="does not fit"):
                    tslices.partition_host(topo, profiles)
    assert fits > 20


def test_partition_host_first_fit_across_gpus():
    topo = ttopo.parse_topology("h100-2")
    plan = [tslices.SliceProfile.parse(n) for n in
            ("1g.10gb", "4g.40gb", "3g.40gb", "3g.40gb", "1g.10gb", "2g.20gb")]
    placed = tslices.partition_host(topo, plan)
    _disjoint(placed)
    # largest first: 4g and a 3g fill GPU 0; the rest pack GPU 1 only
    # with the 3g at slot 4 (at slot 0 the second 1g would need slot 7)
    assert [p.name for p in placed] == [
        "4g.40gb@0:0", "3g.40gb@0:4", "2g.20gb@1:0", "1g.10gb@1:2",
        "1g.10gb@1:3", "3g.40gb@1:4"]
    assert sorted(p.profile.name for p in placed) == sorted(p.name for p in plan)
    assert len(tslices.default_plan(topo)) == 4
    assert [p.name for p in tslices.partition_host(topo, tslices.default_plan(topo))] \
        == ["3g.40gb@0:0", "3g.40gb@0:4", "3g.40gb@1:0", "3g.40gb@1:4"]
    with pytest.raises(ValueError, match="does not fit"):
        tslices.partition_host(topo, [tslices.H100_PROFILES["7g.80gb"]] * 3)


def test_mig_minors_numbering():
    # /proc/driver/nvidia-caps/mig-minors: config 1, monitor 2, gpu0/gi0 3
    assert tslices.mig_minor(0, 0) == 3
    assert tslices.mig_minor(0, 1) == 12 and tslices.mig_minor(0, 1, 0) == 13
    assert tslices.mig_minor(1, 0) == 138
    assert tslices.mig_paths(0, 12, 13) == (
        "/dev/nvidia0", "/dev/nvidia-caps/nvidia-cap12",
        "/dev/nvidia-caps/nvidia-cap13")


MIG_HOST = {0: ["3g.40gb", "3g.40gb"], 1: ["1g.10gb"] * 7,
            2: ["4g.40gb", "2g.20gb", "1g.10gb"], 5: ["7g.80gb"]}


def test_mixed_chip_map_on_a_fake_h100_8():
    backend = TFake("h100-8", mig=MIG_HOST)
    topo = backend.host_topology()
    resources = t_discover("mixed", topo, "3g.40gb,1g.10gb,4g.40gb,2g.20gb,7g.80gb")
    cm = t_new_chip_map(backend, resources, "mixed")
    assert {k: len(v) for k, v in cm.items()} == {
        "nvidia.com/gpu": 4, "nvidia.com/mig-3g.40gb": 2,
        "nvidia.com/mig-1g.10gb": 8, "nvidia.com/mig-4g.40gb": 1,
        "nvidia.com/mig-2g.20gb": 1, "nvidia.com/mig-7g.80gb": 1}
    assert cm["nvidia.com/gpu"].indices() == [3, 4, 6, 7]
    migs = backend.enumerate_mig()
    assert [m.start for m in migs if m.parent_index == 2] == [0, 4, 6]
    assert len({m.uuid for m in migs}) == len(migs) == 13
    assert all(m.uuid.startswith("MIG-") for m in migs)
    assert TFake("h100-8", mig=MIG_HOST).enumerate_mig() == migs  # stable
    half = next(iter(cm["nvidia.com/mig-3g.40gb"].values()))
    assert half.chip_indices == (0,) and half.coords == ((0,),)
    assert half.total_memory == 40 * 1024**3 and half.is_slice
    assert half.paths == ("/dev/nvidia0", "/dev/nvidia-caps/nvidia-cap12",
                          "/dev/nvidia-caps/nvidia-cap13")
    assert not cm["nvidia.com/mig-1g.10gb"].aligned_allocation_supported()
    # a profile no resource names is a hard error
    with pytest.raises(ValueError, match="no resource pattern matches"):
        t_new_chip_map(backend, t_discover("mixed", topo, "3g.40gb"), "mixed")
    # shared replicas of MIG instances
    shared = t_new_chip_map(backend, resources, "mixed", shared_replicas=2)
    assert len(shared["nvidia.com/mig-1g.10gb"]) == 16
    assert len(shared["nvidia.com/mig-1g.10gb"].physical_ids()) == 8


def test_single_chip_map_on_a_fake_h100_8():
    uniform = {g: ["1g.20gb"] * 4 for g in range(8)}
    backend = TFake("h100-8", mig=uniform)
    resources = t_discover("single")
    cm = t_new_chip_map(backend, resources, "single", slice_shape="1g.20gb")
    assert list(cm) == ["nvidia.com/gpu"] and len(cm["nvidia.com/gpu"]) == 32
    assert {c.slice_profile for c in cm["nvidia.com/gpu"].values()} == {"1g.20gb"}
    assert t_new_chip_map(backend, resources, "single") == cm  # shape inferred
    with pytest.raises(ValueError, match="single wants"):
        t_new_chip_map(backend, resources, "single", slice_shape="2g.20gb")
    with pytest.raises(ValueError, match="single wants"):
        t_new_chip_map(TFake("h100-8", mig=MIG_HOST), resources, "single")
    # no GPU in MIG mode: whole GPUs, as under none
    whole = t_new_chip_map(TFake("h100-8"), resources, "single")
    assert whole == t_new_chip_map(TFake("h100-8"), resources, "none")
    # none advertises whole GPUs whatever the MIG mode
    assert len(t_new_chip_map(backend, resources, "none")["nvidia.com/gpu"]) == 8
    # a GPU in MIG mode with no instance: no device under mixed, and
    # single wants a profile on every GPU
    empty = TFake("h100-2", mig={0: []})
    mixed = t_new_chip_map(empty, t_discover("mixed", empty.host_topology(),
                                             "1g.10gb"), "mixed")
    assert {k: v.indices() for k, v in mixed.items()} == {"nvidia.com/gpu": [1]}
    with pytest.raises(ValueError, match="single wants"):
        t_new_chip_map(empty, resources, "single")
    with pytest.raises(ValueError, match="unknown slice strategy"):
        t_new_chip_map(backend, resources, "sliced")


def test_fake_backend_models_h100_hosts():
    backend = TFake("h100-4")
    specs = backend.enumerate_chips()
    assert [s.paths for s in specs] == [(f"/dev/nvidia{i}",) for i in range(4)]
    assert [s.numa_node for s in specs] == [0, 0, 1, 1]
    assert all(s.uuid.startswith("GPU-") and s.generation == "h100" for s in specs)
    assert specs == TFake("h100-4").enumerate_chips()
    assert specs != TFake("h100-4", host_id="other").enumerate_chips()
    backend.set_unhealthy(1, 2)
    assert backend.check_health() == {0: True, 1: False, 2: False, 3: True}
    backend.set_healthy(2)
    assert backend.check_health() == {0: True, 1: False, 2: True, 3: True}
    with pytest.raises(ValueError, match="does not fit"):
        TFake("h100-2", mig={0: ["4g.40gb", "4g.40gb"]})
    with pytest.raises(ValueError):
        TFake("h100-2", mig={2: ["1g.10gb"]})


def test_factory_never_falls_back_to_the_fake(tmp_path, monkeypatch):
    assert make_backend("fake").host_topology().bounds == (8,)
    assert make_backend("fake", "h100-2").host_topology().bounds == (2,)
    with pytest.raises(ValueError):
        make_backend("tpu")
    # native and auto on a host with no NVML library: the loader's own
    # message, never a fake host
    monkeypatch.setenv("GPUENUM_ROOT", str(tmp_path))
    for kind in ("native", "auto"):
        with pytest.raises(RuntimeError, match="cannot load .*nope.so"):
            make_backend(kind, nvml_library=str(tmp_path / "nope.so"))
