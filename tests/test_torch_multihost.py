"""The port's process enrollment (lins_tpu_torch/parallel/multihost.py), the
counterpart of tests/test_multihost.py:

  * the single-process fallback: no JAX_COORDINATOR, no group, a mesh of
    this process's devices, the whole batch local;
  * two real processes enrolled through the reference's variables
    (JAX_COORDINATOR=127.0.0.1:<port>, JAX_NUM_PROCESSES=2,
    JAX_PROCESS_ID) with gloo on the CPU.  Each runs an `all_reduce`,
    `local_batch_slice` and `make_global_batch` (every rank gets the
    concatenation of every rank's rows), and the edge-sharded dense and
    sparse solves split over the two processes, which equal the
    one-process 2-shard solves within 1e-12 m;
  * two processes each holding half of a keyframe store
    (`shard_store` over the two-process mesh): the window assembly, the
    window rebuild, a write into the other process's half and the whole
    store gathered back equal the unsharded ones bit for bit.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import torch

from lins_tpu_torch.parallel import multihost

_WORKER = r"""
import os, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
import torch.distributed as dist

from lins_tpu_torch.graph import pose_graph as pg
from lins_tpu_torch.parallel import dist_graph, multihost

torch.set_num_threads(1)
pid = int(os.environ["JAX_PROCESS_ID"])
assert multihost.initialize(device="cpu", timeout_s=120), "not enrolled"
assert multihost.process_count() == 2 and multihost.process_index() == pid
mesh = multihost.global_mesh(["cpu"])
assert mesh.size == 2 and mesh.offset == pid, mesh

x = torch.tensor([1.0 + pid, 10.0])
dist.all_reduce(x)
assert x.tolist() == [3.0, 20.0], x

rows = np.arange(4 * 3, dtype=np.float64).reshape(4, 3)
sl = multihost.local_batch_slice(mesh, 4)
assert sl == slice(2 * pid, 2 * pid + 2), sl
batch = multihost.make_global_batch(mesh, {{"x": rows[sl],
                                            "n": np.arange(2) + 2 * pid}})
assert batch["x"].shape == (4, 3) and np.array_equal(batch["x"].numpy(), rows)
assert batch["n"].tolist() == [0, 1, 2, 3]

# the chain graph of tests/test_parallel.py, in the port
n, K = 24, 32
rng = np.random.default_rng(0)
f64 = torch.float64
edges = pg.empty_edges(64, f64)
e = torch.tensor([1.0, 0, 0, 0], dtype=f64)
gt = np.cumsum(np.tile([1.0, 0, 0], (n, 1)), axis=0) - [1, 0, 0]
for k in range(n - 1):
    edges = pg.add_edge(edges, torch.tensor(k), torch.tensor(k + 1),
                        torch.tensor([1.0, 0, 0], dtype=f64), e, 1e4, 1e4)
edges = pg.add_edge(edges, torch.tensor(n - 1), torch.tensor(0),
                    torch.tensor(gt[0] - gt[n - 1]), e, 1e4, 1e4)
pos = torch.zeros((K, 3), dtype=f64)
pos[:n] = torch.tensor(gt + rng.normal(0, 0.03, gt.shape).cumsum(axis=0))
quat = torch.zeros((K, 4), dtype=f64)
quat[:, 0] = 1.0
local2 = multihost.Mesh(["cpu", "cpu"])
for make, kw in ((dist_graph.make_sharded_optimizer, dict(iters=6)),
                 (dist_graph.make_sharded_cg_optimizer,
                  dict(iters=6, cg_iters=48))):
    p2, q2 = make(mesh, K, **kw)(pos, quat, torch.tensor(n), edges)
    p1, q1 = make(local2, K, **kw)(pos, quat, torch.tensor(n), edges)
    err = float((p2 - p1).abs().max())
    assert err <= 1e-12 and float((p2 - pos).abs().max()) > 0.05, err
multihost.shutdown()
print(f"MULTIHOST_OK {{pid}}", flush=True)
"""


_STORE_WORKER = r"""
import os, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch

from lins_tpu_torch.config import VLP16
from lins_tpu_torch.mapping import keyframes as kf
from lins_tpu_torch.mapping import local_map as lmn
from lins_tpu_torch.parallel import multihost
from lins_tpu_torch.parallel.shard_map_store import shard_store, unshard_store
from lins_tpu_torch.utils.tree import tree_map

torch.set_num_threads(1)
pid = int(os.environ["JAX_PROCESS_ID"])
assert multihost.initialize(device="cpu", timeout_s=120), "not enrolled"
mesh = multihost.global_mesh(["cpu"])
assert mesh.size == 2 and mesh.offset == pid, mesh

# the same seeded store in both processes: 12 keyframes in 8 slots
f64 = torch.float64
cfg = VLP16.replace(max_keyframes=8)
rng = np.random.default_rng(0)
store = kf.empty_store(cfg, 16, 32, 8, dtype=f64)
for i in range(12):
    q = rng.normal(size=4)
    cl = [torch.as_tensor(rng.uniform(-5, 5, (n, 3))) for n in (16, 32, 8)]
    ok = [torch.as_tensor(rng.random(n) < 0.9) for n in (16, 32, 8)]
    store = kf.add_keyframe(store, torch.as_tensor(rng.uniform(-3, 3, 3)),
                            torch.as_tensor(q / np.linalg.norm(q)),
                            torch.tensor(float(i), dtype=f64), cl[0], ok[0],
                            cl[1], ok[1], cl[2], ok[2])
sharded = shard_store(store, mesh)
assert sharded.surf.parts[0].shape[0] == 4 and len(sharded.surf.parts) == 1


def equal(a, b):
    xs, ys = [], []
    tree_map(xs.append, a)
    tree_map(ys.append, b)
    assert len(xs) == len(ys) > 0
    assert all(torch.equal(x, y) for x, y in zip(xs, ys))


center = torch.tensor(11, dtype=torch.int32)
for outl in (False, True):
    equal(kf.assemble_local_map(sharded, center, 6, 256, 512, 0.2, 0.4, outl),
          kf.assemble_local_map(store, center, 6, 256, 512, 0.2, 0.4, outl))
gp = lmn.grid_params(cfg)
lm = lmn.empty_local_map(cfg, 6, 16, 32, 8, f64, gp, "cpu")
ids, ok, wslots = lmn.recent_window_ids(store, 6)
equal(lmn.rebuild_window(lm, sharded, ids, ok, wslots, gp),
      lmn.rebuild_window(lm, store, ids, ok, wslots, gp))
# slot 5 lives in process 1's half
row = torch.as_tensor(rng.normal(size=(32, 3)))
i = torch.tensor(5)
got = kf.put_row(sharded.surf, i, row)
assert torch.equal(got.gather(), kf.put_row(store.surf, i, row))
equal(unshard_store(sharded), store)
multihost.shutdown()
print(f"STORE_OK {{pid}}", flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_single_process_fallback(monkeypatch):
    for var in ("JAX_COORDINATOR", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize(device="cpu") is False
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    mesh = multihost.global_mesh(["cpu"] * 3)
    assert mesh.group is None and mesh.size == 3 and mesh.offset == 0
    sl = multihost.local_batch_slice(mesh, 16)
    assert (sl.start, sl.stop) == (0, 16)
    x = np.arange(12.0).reshape(4, 3)
    got = multihost.make_global_batch(mesh, (x, {"y": x[:, 0]}))
    np.testing.assert_array_equal(got[0].numpy(), x)
    np.testing.assert_array_equal(got[1]["y"].numpy(), x[:, 0])
    parts = [torch.full((2,), float(k)) for k in range(3)]
    assert mesh.psum(parts).tolist() == [3.0, 3.0]


def _run_two(tmp_path, worker, ok_line):
    """Run `worker` in two processes enrolled through the reference's
    variables; each must exit 0 and print `ok_line` and its id."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "worker.py"
    script.write_text(worker.format(repo=repo))
    coord = f"127.0.0.1:{_free_port()}"
    procs = []
    for i in range(2):
        env = dict(os.environ, JAX_COORDINATOR=coord, JAX_NUM_PROCESSES="2",
                   JAX_PROCESS_ID=str(i), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (rc, out) in enumerate(outs):
        assert rc == 0, f"worker {i} failed:\n{out}"
        assert f"{ok_line} {i}" in out, out


def test_two_process_enrollment(tmp_path):
    _run_two(tmp_path, _WORKER, "MULTIHOST_OK")


def test_two_process_sharded_store(tmp_path):
    _run_two(tmp_path, _STORE_WORKER, "STORE_OK")
