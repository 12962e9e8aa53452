"""Worker for the 2-process INTEGRATED multi-host daemon test (run by
tests/test_distributed.py, one process per 'host').

Unlike dist_worker.py (which covers the decode *library*), this runs
the full production surface end to end per rank: multicli argument
parsing -> jax.distributed.initialize -> rank_slice channel assignment
-> SyntheticRawBank raw uint8 ingest -> batched decimator -> staged
decode across the rank's local devices -> printed spots + stats. The
reference's whole live path (rtlsdr_wsprd.c:126-328) is one process,
one dongle; this is that chain scaled to N processes as one system
(SURVEY.md section 5, BASELINE.md "N>=2 hosts").

Usage: python dist_daemon_worker.py <rank> <nprocs> <port>
"""

import os
import sys

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

rank, nprocs, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=2").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from rtlsdr_wsprd_tpu import compile_cache  # noqa: E402

compile_cache.enable()

from rtlsdr_wsprd_tpu import multicli  # noqa: E402


def main() -> None:
    # 4 global synthetic channels split 2/2; --devices all additionally
    # shards each rank's 2 channels over its 2 local virtual devices
    # (the one-host-many-chips layout inside the many-hosts layout)
    rc = multicli.main([
        "--synth", "4", "-n", "1", "-x", "-Q", "--device-batch", "2",
        "--devices", "all",
        "--coordinator", f"127.0.0.1:{port}",
        "--nprocs", str(nprocs), "--rank", str(rank),
    ])
    assert rc == 0, rc
    assert jax.process_count() == nprocs
    print(f"DAEMON_DIST_OK rank={rank}", flush=True)


if __name__ == "__main__":
    main()
