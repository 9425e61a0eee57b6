"""Fabric host subprocess entry: ``python -m analyzer_tpu_torch.fabric.process
spec.json``.

The port's copy of ``analyzer_tpu.fabric.process``. One invocation = one
shard-owning host of the fabric. The spec (JSON, argv[1]) is a
:class:`~analyzer_tpu_torch.fabric.host.FabricHostConfig` plus the file
handshake:

  * ``ready_file`` — written atomically (tmp + rename) once the host's
    three listeners are up, carrying the bound ports/urls the parent
    needs: ``{"host", "serve_url", "control_url", "obs_port", "pid",
    "bringup"}``; ``bringup`` holds the child's wall seconds to reach its
    device (``context_s``: the CUDA context on the card) and to build the
    host (``build_s``);
  * ``exit_file`` — the parent touches it to end the process; until then
    the host keeps serving ``/v1/*``, ``/fabric/*`` and obsd;
  * ``trace`` — arms causal tracing before the worker builds (both the env
    var and the live flag: a ``-m`` launch imports the package — and the
    obs modules — before the spec is read);
  * ``trace_out`` — dump the host's chrome trace there on exit, so the
    parent can ``load_forest`` it with its own (host label = basename);
  * ``device`` — where the host rates and serves: absent or null is the
    card (JAX's spec names a ``platform``, default cpu). A child asked for
    the card on a machine without one raises before it writes its ready
    file; it never carries on on the CPU.

The lifetime loop below reads the wall clock: a subprocess's liveness
deadline is wall-shaped by nature (the parent that feeds it virtual time
may have died). Every DECISION inside the host stays on the virtual clock.
"""

import json
import os
import sys
import time


def main(argv=None) -> None:
    args = list(sys.argv[1:] if argv is None else argv)
    with open(args[0], encoding="utf-8") as f:
        spec = json.load(f)
    if spec.get("trace"):
        # ``-m`` runs import the fabric package (and with it the obs
        # modules) before this line — the env var alone is too late, so
        # flip the process-wide flag through the API as well.
        os.environ["ANALYZER_TPU_TRACE"] = "1"
        from analyzer_tpu_torch.obs import tracectx

        tracectx.enable_tracing(True)

    import torch

    from analyzer_tpu_torch.device import resolve_device
    from analyzer_tpu_torch.fabric.host import FabricHost, FabricHostConfig

    t0 = time.perf_counter()  # graftlint: disable=GL048 — measured bring-up seconds (the ready file's bringup), not a decision input
    device = resolve_device(spec.get("device"))
    if device.type == "cuda":
        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
    t1 = time.perf_counter()  # graftlint: disable=GL048 — measured bring-up seconds, not a decision input
    cfg = FabricHostConfig(
        host=spec["host"],
        n_shards=spec["n_shards"],
        n_hosts=spec["n_hosts"],
        seed=spec.get("seed", 0),
        n_players=spec.get("n_players", 400),
        batch_size=spec.get("batch_size", 64),
        quality=spec.get("quality", True),
        slo_plane=spec.get("slo_plane", True),
        device=str(device),
    )
    host = FabricHost(cfg)
    t2 = time.perf_counter()  # graftlint: disable=GL048 — measured bring-up seconds, not a decision input
    tmp = spec["ready_file"] + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(
            {
                "host": host.host,
                "serve_url": host.serve_url,
                "control_url": host.control_url,
                "obs_port": host.obs_port,
                "pid": os.getpid(),
                "bringup": {"context_s": t1 - t0, "build_s": t2 - t1},
            },
            f,
        )
    os.replace(tmp, spec["ready_file"])
    deadline = time.time() + float(spec.get("max_wall_s", 600.0))  # graftlint: disable=GL048 — subprocess liveness deadline, wall-shaped by nature
    while time.time() < deadline and not os.path.exists(spec["exit_file"]):  # graftlint: disable=GL048 — subprocess liveness poll, wall-shaped by nature
        time.sleep(0.05)  # graftlint: disable=GL048 — idle wait for the parent's exit signal
    if spec.get("trace_out"):
        from analyzer_tpu_torch.obs.snapshot import write_chrome_trace

        write_chrome_trace(spec["trace_out"])
    host.close()


if __name__ == "__main__":
    main()
