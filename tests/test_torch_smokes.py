"""The port's serving drills as ``--device cpu`` subprocesses:
``scripts/server_smoke_torch.py`` (both reply transports: client
processes bit-identical to in-process, a fresh client decoding zero
tiles, the shm pool draining to zero, a clean SIGTERM) and
``scripts/cluster_smoke_torch.py`` (3 nodes and a router: a node
SIGKILLed mid-workload with no read lost, a repair whose destination is
killed mid-copy and resumes, a clean shutdown)."""
from _torch_entry import run


def test_server_smoke_on_the_cpu():
    out = run("server_smoke_torch", "--device", "cpu")
    assert out.returncode == 0, out.stdout + out.stderr
    for transport in ("shm", "socket"):
        assert f"# [{transport}] two concurrent clients bit-identical" \
            in out.stdout
        assert f"# [{transport}] warm repeat from a fresh process decoded " \
            "0 tiles" in out.stdout
        assert f"# [{transport}] clean shutdown: exit 0" in out.stdout
    assert "# [shm] segment pool drained to 0" in out.stdout
    assert out.stdout.splitlines()[-1] == "server_smoke_torch,0.0,ok"


def test_cluster_smoke_on_the_cpu():
    out = run("cluster_smoke_torch", "--device", "cpu")
    assert out.returncode == 0, out.stdout + out.stderr
    for line in ("# two concurrent clients bit-identical",
                 "mid-workload: 6/6 waves bit-identical",
                 "# destination SIGKILLed mid-copy and restarted",
                 "# zero failed reads during repair: 6/6 waves",
                 "rebuilt replica bit-identical, post-retile epoch",
                 "# clean shutdown: router and surviving nodes exit 0"):
        assert line in out.stdout, line
    assert out.stdout.splitlines()[-1] == "cluster_smoke_torch,0.0,ok"
