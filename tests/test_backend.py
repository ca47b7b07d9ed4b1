"""The backend switch (cvt_tpu.ops.backend.scan_route): every platform
gets its route, 'auto' never interprets, and anything else raises."""

from types import SimpleNamespace

import jax
import numpy as np
import pytest

from cvt_tpu.ops.backend import scan_route


def _devs(*platforms):
    return [SimpleNamespace(platform=p) for p in platforms]


@pytest.mark.parametrize("platform,impl,route", [
    ("gpu", "auto", "pallas"),
    ("gpu", "pallas", "pallas"),
    ("gpu", "xla", "xla"),
    ("cpu", "auto", "xla"),
    ("cpu", "pallas", "interpret"),
    ("cpu", "xla", "xla"),
])
def test_route_per_platform(platform, impl, route):
    assert scan_route(_devs(platform, platform), impl) == route


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_auto_never_interprets(platform):
    assert scan_route(_devs(platform)) != "interpret"


@pytest.mark.parametrize("platform", ["tpu", "rocm", "METAL"])
@pytest.mark.parametrize("impl", ["auto", "pallas", "xla"])
def test_unknown_platform_raises(platform, impl):
    with pytest.raises(ValueError, match="no scan route"):
        scan_route(_devs(platform), impl)


def test_unknown_impl_and_mixed_platforms_raise():
    with pytest.raises(ValueError, match="unknown impl"):
        scan_route(_devs("cpu"), "triton")
    with pytest.raises(ValueError, match="several platforms"):
        scan_route(_devs("cpu", "gpu"))


def test_mesh_and_default_device():
    """A mesh's device array and the default device are both accepted;
    on the CPU test machine the default route is plain XLA."""
    from cvt_tpu.parallel import cpu_mesh
    mesh = cpu_mesh({"db": 2})
    assert scan_route(mesh.devices) == "xla"
    assert scan_route(mesh.devices, "pallas") == "interpret"
    with jax.default_device(jax.devices("cpu")[0]):
        assert scan_route() == "xla"
    assert scan_route(np.asarray(_devs("gpu", "gpu"))) == "pallas"
