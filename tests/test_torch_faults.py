"""The port's fault plane against the reference's
(``serving/faults.py``): for the same spec both fire on the same hits,
refuse the same malformed specs with the same message, and resolve a
disarmed point to ``None``."""

import pytest

from k8s_gpu_device_plugin_torch.serving import faults as tf
from k8s_gpu_device_plugin_tpu.serving import faults as jf

SPECS = [
    "decode.apply:nth=40",
    "pool.alloc:p=0.3:seed=3:times=6",
    "pool.alloc:nth=2:times=3",
    "prefill.dispatch:p=0.05:seed=11,prefix.promote:nth=3:times=2",
    "health.handler",
    "router.connect:p=0.5:seed=7,router.midstream:nth=5",
]


def _fires(plane, name: str, hits: int, error) -> list[int]:
    pt = plane.point(name)
    fired = []
    for i in range(hits):
        try:
            pt.fire()
        except error:
            fired.append(i)
    return fired


@pytest.mark.parametrize("spec", SPECS)
def test_firing_sequence_equals_the_reference(spec):
    tp, jp = tf.FaultPlane.from_spec(spec), jf.FaultPlane.from_spec(spec)
    names = [e.split(":")[0] for e in spec.split(",")]
    for name in names:
        got = _fires(tp, name, 200, tf.FaultError)
        want = _fires(jp, name, 200, jf.FaultError)
        assert got == want and got
    assert tp.stats() == jp.stats()


@pytest.mark.parametrize("spec", [
    "decode.apply:nth=1:p=0.5", "no.such.point", "pool.alloc:p=2",
    "pool.alloc:nth", "pool.alloc:bogus=1", "decode.apply,decode.apply",
    "pool.alloc:times=-1:nth=1", "health.handler:delay_ms=-5",
])
def test_spec_errors_equal_the_reference(spec):
    with pytest.raises(ValueError) as want:
        jf.FaultPlane.from_spec(spec)
    with pytest.raises(ValueError) as got:
        tf.FaultPlane.from_spec(spec)
    assert str(got.value) == str(want.value)


def test_disarmed_points_delay_and_env(monkeypatch):
    assert tf.FaultPlane.from_spec("") is None
    assert tf.FaultPlane.from_spec("  ") is None
    plane = tf.FaultPlane.from_spec("decode.apply:nth=2")
    assert plane.point("pool.alloc") is None
    with pytest.raises(ValueError, match="unknown fault point"):
        plane.point("pool.aloc")
    assert plane.error is tf.FaultError
    # a delay point sleeps instead of raising
    slow = tf.FaultPlane()
    pt = slow.arm("health.handler", nth=1, delay_ms=1)
    pt.fire()
    assert (pt.hits, pt.fired) == (1, 1)
    monkeypatch.setenv("TPU_SERVING_FAULTS", "prefill.dispatch:nth=3")
    env = tf.FaultPlane.from_cli("")
    assert env.point("prefill.dispatch").nth == 3
    with pytest.raises(SystemExit):
        tf.FaultPlane.from_cli("bogus.point")
