"""Two-process test of the port's distributed solve (parallel/
distributed.py), mirroring tests/test_distributed.py: two real processes
join one gloo process group on the CPU (a file:// rendezvous in the test's
own directory, so parallel test workers never share a port) and solve a
goal batch split between them. Both must report identical metrics, and the
same metrics as one process solving the whole batch, to the tolerances of
tests/test_distributed.py. The workers run tools/torch_distributed_worker.py,
the same entry point a launcher uses."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tools", "torch_distributed_worker.py")


def _env(**kw):
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(GRAPHIK_DEVICE="cpu", GRAPHIK_GOALS="8", OMP_NUM_THREADS="1", **kw)
    return env


def test_two_process_solve_matches_single(tmp_path):
    init = f"file://{tmp_path / 'rendezvous'}"
    outs = [str(tmp_path / f"proc{r}.json") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, WORKER], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE,
                              env=_env(WORLD_SIZE="2", RANK=str(r), GRAPHIK_INIT_METHOD=init,
                                       GRAPHIK_OUT=outs[r]))
             for r in range(2)]
    failures = []
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
            failures.append((r, "timeout", err.decode()[-2000:]))
            continue
        if p.returncode != 0:
            failures.append((r, p.returncode, err.decode()[-2000:]))
    assert not failures, failures

    results = [json.load(open(f)) for f in outs]
    assert [r["process"] for r in results] == [0, 1]
    assert [r["local_batch"] for r in results] == [4, 4]
    # identical (all-reduced) metrics on both processes
    assert results[0]["metrics"] == results[1]["metrics"]
    assert results[0]["metrics"]["num_processes"] == 2
    assert results[0]["metrics"]["global_batch"] == 8
    assert results[0]["world"] == 2

    # oracle: one process, no process group, the whole batch
    single_out = str(tmp_path / "single.json")
    p = subprocess.run([sys.executable, WORKER], cwd=REPO, env=_env(GRAPHIK_OUT=single_out),
                       timeout=300, capture_output=True)
    assert p.returncode == 0, p.stderr.decode()[-2000:]
    single = json.load(open(single_out))
    assert single["metrics"]["num_processes"] == 1 and single["local_batch"] == 8
    for k in ("success_rate", "pose_only_rate"):
        assert abs(results[0]["metrics"][k] - single["metrics"][k]) < 1e-6, k
    assert abs(results[0]["metrics"]["mean_pos_err"] - single["metrics"]["mean_pos_err"]) < 1e-5
