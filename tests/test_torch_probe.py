"""The live bandwidth probe of the PyTorch package
(``core/cluster.py::profile_bandwidth_live``).

On the host the probe is asked for the CPU by name: one device gives the
1x1 ``inf`` matrix the JAX package's probe gives on its one CPU device;
two host "devices" time a host copy each way.  ``devices=None`` means
every visible CUDA device and raises without one.  The card's form (CUDA
events on the source device) runs in ``tests/test_torch_gpu.py`` and in
``chip_smoke.py``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.cluster import profile_bandwidth_live as r_probe
from repro_torch.core.cluster import profile_bandwidth_live


def test_one_cpu_device_is_the_reference_1x1_inf():
    got = profile_bandwidth_live(devices=["cpu"])
    want = r_probe(devices=jax.devices("cpu")[:1])
    assert got.shape == want.shape == (1, 1)
    assert np.isinf(got).all() and np.isinf(want).all()
    assert got.dtype == want.dtype == np.float64


def test_two_host_devices_time_each_copy():
    bw = profile_bandwidth_live(devices=["cpu", torch.device("cpu")],
                                msg_bytes=1 << 16)
    assert bw.shape == (2, 2)
    assert np.isinf(np.diag(bw)).all()
    off = bw[~np.eye(2, dtype=bool)]
    assert np.isfinite(off).all() and (off > 0).all()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is "
                    "present; the no-device error cannot show")
def test_probe_needs_a_device_or_the_cpu_named():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profile_bandwidth_live()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profile_bandwidth_live(devices=["cuda"])
