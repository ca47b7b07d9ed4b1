"""True multi-process distributed serving: 2 jax.distributed processes
(CPU backend, 4 virtual devices each) ingest their own code shards via
make_array_from_process_local_data and serve one step; process 0's
result must EXACTLY match the single-process 8-device run.

This is the first genuine exercise of the per-host ingestion path the
multi-host config-5 story depends on (SURVEY §2.5 item 4) — everything
else multi-device in the suite runs in ONE process on a virtual mesh.
The reference has no distributed surface at all (SURVEY §5.8).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import os, sys, json
import numpy as np

pid = int(sys.argv[1])
port = sys.argv[2]
tmp = sys.argv[3]

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")
import jax
jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                           num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, len(jax.devices())

from cvt_tpu.parallel.serving import MultiHostADCServer, serving_mesh
from cvt_tpu.quant import OPQ

z = np.load(os.path.join(tmp, "fixture.npz"))
opq = OPQ.load(os.path.join(tmp, "opq.npz"))
server = MultiHostADCServer(opq, serving_mesh(), seg=32)
n_global = int(z["codes"].shape[0])
start, stop, per = server.shard_rows(n_global)
# THIS process loads only its own rows — nobody holds the full matrix
server.load_local(z["codes"][start:stop], n_global=n_global)
d, i = server.serve(z["queries"], k=5)
if pid == 0:
    np.savez(os.path.join(tmp, "out_mp.npz"),
             d=np.asarray(d), i=np.asarray(i))
print(json.dumps({"pid": pid, "start": int(start), "stop": int(stop),
                  "ok": True}))
"""


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_distributed_serving(tmp_path):
    import jax
    from cvt_tpu.parallel.serving import MultiHostADCServer
    from cvt_tpu.quant import OPQ

    rng = np.random.default_rng(0)
    n, d = 1024, 32
    base = rng.normal(0, 20, (n, d)).astype(np.float32)
    queries = rng.normal(0, 20, (16, d)).astype(np.float32)
    opq = OPQ.train(jax.random.key(0), base[:512], m=4, k=16,
                    opq_iters=1, kmeans_iters=3, final_kmeans_iters=3)
    opq.save(str(tmp_path / "opq.npz"))

    # single-process 8-device reference (conftest's virtual mesh)
    from cvt_tpu.parallel.serving import serving_mesh
    ref = MultiHostADCServer(opq, serving_mesh(), seg=32)
    codes = ref.encode(base)
    np.savez(tmp_path / "fixture.npz", codes=codes, queries=queries)
    ref.load_local(codes, n_global=n)
    d_ref, i_ref = ref.serve(queries, k=5)
    d_ref, i_ref = np.asarray(d_ref), np.asarray(i_ref)

    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["JAX_PLATFORMS"] = "cpu"
    pp = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + pp)
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(pid), str(port), str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pid in range(2)]
    outs = [p.communicate(timeout=420) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]
    # both workers report disjoint covering shards
    stats = [json.loads(so.decode().strip().splitlines()[-1])
             for so, _ in outs]
    stats.sort(key=lambda s: s["pid"])
    assert stats[0]["start"] == 0
    assert stats[0]["stop"] == stats[1]["start"]
    assert stats[1]["stop"] == n

    z = np.load(tmp_path / "out_mp.npz")
    np.testing.assert_array_equal(z["i"], i_ref)
    np.testing.assert_allclose(z["d"], d_ref, rtol=0, atol=0)
