"""The port's host ring buffers, native scan ring, two-stage downsample and
packed frame outputs against the JAX package's.

- `TimedRingBuffer`: the JAX package's TestBuffers, on the port's copy;
- `ScanRing` (native) and `ScanRingNumpy` (its plain version): the JAX
  package's SPSC test, plus a full ring refusing a push and a scan cut to
  its slot, and the same push/pop sequence through the JAX package's
  native ring giving the same answers;
- `downsample_two_stage`: the port's native and numpy versions and the
  JAX package's native and numpy versions give the same bytes;
- `pack_output` / `HostFrameOutput`: the JAX package's round trip on the
  port, the layout tables equal to the JAX package's, and the port's packed
  buffers equal to JAX's `pack_output` of the same values.
"""

import threading

import numpy as np
import pytest
import torch

from svnicp_tpu.io import native as jnative
from svnicp_tpu.runtime import packing as jpacking
from svnicp_tpu.runtime import pipeline as jpl
from svnicp_tpu_torch.io import native
from svnicp_tpu_torch.runtime import buffers, packing
from svnicp_tpu_torch.runtime import pipeline as tpl

RINGS = {"native": native.ScanRing, "numpy": native.ScanRingNumpy}


class TestBuffers:
    def test_fifo_and_nearest(self):
        b = buffers.TimedRingBuffer(capacity=5)
        for i in range(8):
            b.push(f"v{i}", float(i))
        assert len(b) == 5  # capacity bound: oldest dropped
        v, t = b.pop_first()
        assert v == "v3" and t == 3.0
        v, t = b.nearest(5.4)
        assert v == "v5"
        v, t = b.nearest(100.0)
        assert v == "v7"
        v, t = b.at(99)
        assert v == "v7"  # clamps like the reference's id fallback
        assert len(b.drain()) == 4
        assert len(b) == 0


@pytest.mark.parametrize("kind", sorted(RINGS))
def test_scan_ring_spsc(kind, rng):
    """The JAX package's test_scan_ring_spsc on either ring: a full ring
    keeps its 4 scans (the pushes past them are refused), and a threaded
    producer and consumer pass 50 scans in order, byte-equal."""
    make = RINGS[kind]
    ring = make(slots=4, max_points=128)
    assert ring.pop() is None
    a = rng.normal(size=(50, 3)).astype(np.float32)
    assert ring.push(a, 1.5)
    assert len(ring) == 1
    got, t = ring.pop()
    assert t == 1.5
    np.testing.assert_array_equal(got, a)
    # overflow drops the new scan
    pushed = [ring.push(a, float(i)) for i in range(6)]
    assert pushed == [True] * 4 + [False] * 2
    assert len(ring) == 4

    ring2 = make(slots=8, max_points=64)
    scans = [rng.normal(size=(32, 3)).astype(np.float32) for _ in range(50)]
    received = []

    def producer():
        for i, s in enumerate(scans):
            while not ring2.push(s, float(i)):
                pass

    def consumer():
        while len(received) < 50:
            item = ring2.pop()
            if item is not None:
                received.append(item)

    tp, tc = threading.Thread(target=producer), threading.Thread(target=consumer)
    tp.start(); tc.start(); tp.join(); tc.join()
    assert [t for _, t in received] == [float(i) for i in range(50)]
    for (got, t), want in zip(received, scans):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", sorted(RINGS))
def test_full_ring_refuses_and_keeps_the_oldest(kind, rng):
    """A full ring refuses the new scan and keeps the ones it holds, in
    order (the native semantics; the JAX package's fallback for a missing
    library would drop the oldest instead); a scan longer than a slot keeps
    its first max_points points; a popped slot takes a push again."""
    ring = RINGS[kind](slots=3, max_points=10)
    scans = [rng.normal(size=(4 + i, 3)).astype(np.float32) for i in range(5)]
    assert [ring.push(s, float(i)) for i, s in enumerate(scans)] == \
        [True, True, True, False, False]
    got, t = ring.pop()
    assert t == 0.0
    np.testing.assert_array_equal(got, scans[0])
    long = rng.normal(size=(25, 3)).astype(np.float32)
    assert ring.push(long, 9.0)
    assert not ring.push(scans[4], 10.0)
    out = [ring.pop() for _ in range(3)]
    assert [t for _, t in out] == [1.0, 2.0, 9.0]
    np.testing.assert_array_equal(out[2][0], long[:10])
    assert ring.pop() is None and len(ring) == 0


def test_scan_ring_matches_the_jax_native_ring(rng):
    """The same pushes and pops through the port's two rings and the JAX
    package's native ring give the same answers and the same bytes."""
    rings = [native.ScanRing(slots=4, max_points=32),
             native.ScanRingNumpy(slots=4, max_points=32),
             jnative.ScanRing(slots=4, max_points=32)]
    assert jnative.AVAILABLE
    for step in range(40):
        if rng.uniform() < 0.55:
            scan = rng.normal(size=(int(rng.integers(1, 48)), 3)).astype(np.float32)
            got = [r.push(scan, float(step)) for r in rings]
        else:
            got = [r.pop() for r in rings]
            if got[0] is not None:
                for g in got[1:]:
                    np.testing.assert_array_equal(g[0], got[0][0])
                    assert g[1] == got[0][1]
                got = [g[1] for g in got]
        assert got[1:] == got[:1] * 2, (step, got)
        assert len({len(r) for r in rings}) == 1


@pytest.mark.parametrize("voxel,cap_src,cap_map", [(1.0, 256, 512), (0.5, 16, 32),
                                                   (1.5, 16, 16), (0.3, 300, 600)])
def test_downsample_two_stage_matches_jax(voxel, cap_src, cap_map, rng):
    """The port's native and numpy two-stage downsample and the JAX
    package's native and numpy ones give the same clouds, byte for byte,
    at the capacity cut too, with the JAX package's voxel-edge values
    mixed in."""
    xyz = (rng.normal(size=(5000, 3)) * 8).astype(np.float32)
    vals = np.array([7.4999995, -7.4999995, 4.4999995, 1.4999999, 2.9999998,
                     10.499999, 0.0, 1.5], np.float32)
    xyz[:8] = np.stack([vals, vals * 0.5, -vals], axis=1)
    want = jnative.downsample_two_stage(xyz, voxel, cap_src, cap_map)
    m_np = jnative._np_downsample_stage(xyz, 0.5 * voxel, cap_map)
    s_np = jnative._np_downsample_stage(m_np, 1.5 * voxel, cap_src)
    for got in (native.downsample_two_stage(xyz, voxel, cap_src, cap_map),
                native.downsample_two_stage_numpy(xyz, voxel, cap_src, cap_map)):
        assert got[1] == want[1] and got[3] == want[3]
        for g, w in ((got[0], want[0]), (got[2], want[2])):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.tobytes() == w.tobytes()
    if voxel in (1.0, 0.5, 1.5):   # the stage voxels round alike in f64 and f32
        np.testing.assert_array_equal(want[0][:want[1]], m_np)
        np.testing.assert_array_equal(want[2][:want[3]], s_np)


def test_pack_layout_is_the_jax_packages():
    assert packing._PACK_F32 == jpacking._PACK_F32
    assert packing._PACK_I32 == jpacking._PACK_I32
    assert packing._PACK_OFFSETS == jpacking._PACK_OFFSETS
    assert packing._PACK_F32_LEN == jpacking._PACK_F32_LEN == 193


def _frame_values(rng, dtype):
    vals = {name: rng.normal(size=shape or ()).astype(dtype)
            for name, shape in packing._PACK_F32}
    ints = {name: 10 + i for i, name in enumerate(packing._PACK_I32)}
    ints["align_ok"] = True
    return vals, ints


def _port_output(vals, ints, p, h, rng, dtype):
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    kw = {n: torch.as_tensor(v) for n, v in vals.items()}
    for n, v in ints.items():   # the port's step types: host values or tensors
        kw[n] = v if n in packing._HOST_TYPED else torch.tensor(v, dtype=torch.int64)
    return tpl.FrameOutput(
        particles=torch.as_tensor(rng.normal(size=(p, 6))).to(tdt),
        weights=torch.full((p,), 1.0 / p, dtype=tdt),
        history=torch.zeros((h, p, 6), dtype=tdt), **kw)


class TestPackedFrameOutput:
    def test_pack_roundtrip_every_field(self, rng):
        """The JAX package's round trip on the port: HostFrameOutput serves
        every field bit-exactly from the two buffers, with the port's host
        types for the host-typed fields and CPU tensors for the others."""
        p, h = 8, 3
        vals, ints = _frame_values(rng, np.float32)
        out = _port_output(vals, ints, p, h, rng, np.float32)
        packed = packing.pack_output(out)
        assert packed.small.shape == (packing._PACK_F32_LEN,)
        assert packed.ints.dtype == torch.int32
        host = packing.HostFrameOutput(packed)
        for name, shape in packing._PACK_F32:
            got = getattr(host, name)
            assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), getattr(out, name).numpy(),
                                          err_msg=name)
            assert tuple(got.shape) == tuple(shape), name
        for name in packing._PACK_I32:
            got = getattr(host, name)
            if name == "align_ok":
                assert got is True
            elif name in packing._HOST_TYPED:
                assert type(got) is int and got == ints[name], name
            else:
                assert int(got) == ints[name], name
        np.testing.assert_array_equal(host.particles.numpy(), out.particles.numpy())
        assert host.history.shape == (h, p, 6)
        assert host.feature_counts is None
        with pytest.raises(AttributeError):
            host.not_a_field

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_packed_buffers_equal_the_jax_packages(self, dtype, rng):
        """The port's packed buffers hold the same values at the same offsets
        as the JAX package's `pack_output` of the same fields."""
        import jax
        import jax.numpy as jnp

        vals, ints = _frame_values(rng, dtype)
        out = _port_output(vals, ints, 4, 0, rng, dtype)
        packed = packing.pack_output(out)
        with jax.enable_x64(dtype == np.float64):
            jout = jpl.FrameOutput(
                particles=jnp.zeros((4, 6), dtype), weights=jnp.zeros(4, dtype),
                history=jnp.zeros((0, 4, 6), dtype),
                **{n: jnp.asarray(v) for n, v in vals.items()},
                **{n: jnp.asarray(v) if n == "align_ok" else jnp.asarray(v, jnp.int32)
                   for n, v in ints.items()})
            jpacked = jpacking.pack_output(jout)
            jsmall, jints = np.asarray(jpacked.small), np.asarray(jpacked.ints)
        assert jsmall.dtype == packed.small.numpy().dtype
        assert packed.small.numpy().tobytes() == jsmall.tobytes()
        np.testing.assert_array_equal(packed.ints.numpy(), jints)
        jhost = jpacking.HostFrameOutput(jpacked)
        host = packing.HostFrameOutput(packed)
        for name, _ in packing._PACK_F32:
            np.testing.assert_array_equal(getattr(host, name).numpy(),
                                          np.asarray(getattr(jhost, name)), err_msg=name)

    def test_batch_rows_share_one_host_copy(self, rng):
        """pack_outputs stacks F frames into [F, 193] and [F, 6]; each
        facade serves its own row, and the pass-through fields stay the
        frame's own."""
        outs = []
        for _ in range(3):
            vals, ints = _frame_values(rng, np.float64)
            outs.append(_port_output(vals, ints, 5, 0, rng, np.float64))
        packed = packing.pack_outputs(outs)
        assert packed.small.shape == (3, packing._PACK_F32_LEN)
        assert packed.ints.shape == (3, len(packing._PACK_I32))
        hosts = packing.host_outputs(packed)
        assert len({id(h._copy) for h in hosts}) == 1
        for h, o in zip(hosts, outs):
            for name, _ in packing._PACK_F32:
                assert torch.equal(getattr(h, name), getattr(o, name)), name
            assert h.particles is o.particles
            assert int(h.map_points) == int(o.map_points)
