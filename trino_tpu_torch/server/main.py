"""Server entry point: ``python -m trino_tpu_torch.server.main``.

Counterpart of ``trino_tpu/server/main.py`` (host only): the airlift
config model, ``etc/config.properties`` (http-server.http.port,
resource-groups.config-file, password-authenticator.file,
query.max-memory, scan-cache.max-size, spool.backend, plugin.load) and
``etc/catalog/*.properties`` (connector.name=tpch|memory|...,
through plugin.py). The node runs on ``--device`` (default ``cuda``;
no card is an error unless ``--device cpu`` is given). ``--role worker``
(``node.role=worker``) starts a task worker (server/task_worker.py) that
announces itself to ``--coordinator-uri`` (``discovery.uri``) and
re-announces on a cadence; a coordinator dispatches to ``--workers``
(``worker.uris``) and to every worker that announces itself.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import time
from typing import Dict, Optional


def load_properties(path: str) -> Dict[str, str]:
    """key=value lines, '#' comments (airlift config format)."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if "=" in line:
                k, _, v = line.partition("=")
                out[k.strip()] = v.strip()
    return out


def build_catalogs(etc_dir: Optional[str],
                   plugins: Optional[list] = None, device=None):
    """etc/catalog/*.properties -> CatalogManager through the plugin
    registry (connector.name selects the factory), each connector on
    ``device``. Without catalog files: tpch, tpcds, memory, blackhole
    and stream."""
    from .. import plugin
    from ..catalog import CatalogManager
    from ..config import resolve_device
    dev = resolve_device(device)
    for mod in plugins or []:
        plugin.load_plugin(mod)
    cat_dir = os.path.join(etc_dir, "catalog") if etc_dir else None
    mgr = CatalogManager()
    made = False
    if cat_dir and os.path.isdir(cat_dir):
        for fn in sorted(os.listdir(cat_dir)):
            if not fn.endswith(".properties"):
                continue
            name = fn[:-len(".properties")]
            props = load_properties(os.path.join(cat_dir, fn))
            kind = props.get("connector.name", name)
            try:
                mgr.register(name, plugin.create_connector(
                    kind, name, props, dev))
            except KeyError as e:
                print(f"warning: {e} for catalog {name}",
                      file=sys.stderr)
            made = True
    if not made:
        for kind in ("tpch", "tpcds", "memory", "blackhole",
                     "stream"):
            mgr.register(kind, plugin.create_connector(kind, kind,
                                                       device=dev))
    return mgr


def _etc_properties(etc_dir: Optional[str]) -> Dict[str, str]:
    props: Dict[str, str] = {}
    if etc_dir:
        cfg = os.path.join(etc_dir, "config.properties")
        if os.path.exists(cfg):
            props = load_properties(cfg)
    return props


def coordinator_from_etc(etc_dir: Optional[str], device="cuda",
                         port: Optional[int] = None,
                         spool_backend: Optional[str] = None,
                         workers: Optional[str] = None,
                         distributed: bool = False):
    """The Coordinator (not yet started) that ``etc_dir`` describes:
    config.properties and catalog/*.properties; ``port``,
    ``spool_backend`` and ``workers`` (comma-separated base URIs) beat
    their properties. A worker's config (``node.role=worker``) is
    refused: start it with ``--role worker``."""
    props = _etc_properties(etc_dir)
    # plugin.load=<module>[,<module>...] loads plugin modules before the
    # catalogs resolve
    plugins = [m for m in props.get("plugin.load", "").split(",") if m]
    if port is None:
        port = int(props.get("http-server.http.port", "8080"))
    if props.get("node.role", "coordinator") == "worker":
        raise SystemExit("config.properties names the worker role: "
                         "start this node with --role worker")
    workers = [w.strip() for w in
               (workers or props.get("worker.uris", "")).split(",")
               if w.strip()]

    from .coordinator import Coordinator
    from .memory import parse_data_size
    resource_groups = None
    rg_path = props.get("resource-groups.config-file")
    if rg_path:
        import json
        from .resourcegroups import ResourceGroupManager
        with open(rg_path) as f:
            resource_groups = ResourceGroupManager.from_config(
                json.load(f))
    authenticator = None
    pw_path = props.get("password-authenticator.file")
    if pw_path:
        from ..security import load_password_file
        with open(pw_path) as f:
            authenticator = load_password_file(f.read())
    spool_backend = spool_backend or props.get("spool.backend") or None
    # cluster memory pool: query.max-memory (Trino's DataSize strings,
    # "50GB", or raw bytes) beats TRINO_TPU_CLUSTER_MEMORY_POOL
    pool_bytes = None
    if props.get("query.max-memory"):
        pool_bytes = parse_data_size(props["query.max-memory"])
    # the device bytes the scan cache keeps across queries (default
    # 4GB, EngineConfig.scan_cache_bytes)
    scan_cache_bytes = None
    if props.get("scan-cache.max-size"):
        scan_cache_bytes = parse_data_size(props["scan-cache.max-size"])
    return Coordinator(port=port, distributed=distributed,
                       catalogs=build_catalogs(etc_dir, plugins, device),
                       resource_groups=resource_groups,
                       authenticator=authenticator,
                       worker_uris=workers,
                       spool_backend=spool_backend,
                       memory_pool_bytes=pool_bytes,
                       scan_cache_bytes=scan_cache_bytes,
                       device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="trino-tpu-torch-server")
    ap.add_argument("--etc-dir", default=None,
                    help="config directory (config.properties + "
                         "catalog/*.properties)")
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--distributed", action="store_true",
                    help="[coordinator] run queries over the device mesh "
                         "(one shard per visible card)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the queries run on: cuda "
                         "(default) or cpu")
    ap.add_argument("--spool-backend", default=None,
                    help="spool backend: 'local' (directory tree) or "
                         "'memory' (the object-store code path); also "
                         "spool.backend in config.properties / env "
                         "TRINO_TPU_SPOOL_BACKEND")
    ap.add_argument("--role", choices=("coordinator", "worker"),
                    default=None,
                    help="worker starts a task worker instead of a "
                         "coordinator (node.role in config.properties). "
                         "Default: coordinator")
    ap.add_argument("--workers", default=None,
                    help="[coordinator] comma-separated worker base URIs "
                         "to dispatch fragments to; also worker.uris in "
                         "config.properties")
    ap.add_argument("--coordinator-uri", default=None,
                    help="[worker] coordinator to announce this worker "
                         "to (/v1/announcement, again on a cadence); "
                         "also discovery.uri in config.properties")
    ap.add_argument("--coordinator-token", default=None,
                    help="[worker] Bearer token sent with every "
                         "announcement; also discovery.token in "
                         "config.properties / env "
                         "TRINO_TPU_COORDINATOR_TOKEN")
    ap.add_argument("--prewarm-top-k", type=int, default=None,
                    help="[worker] how many of the coordinator's hot "
                         "shapes to warm before announcing this worker "
                         "warm (GET /v1/hotshapes, exec/aot.py); default "
                         "env TRINO_TPU_PREWARM_TOP_K or prewarm.top-k; "
                         "the warm-up is off with TRINO_TPU_PREWARM=0 or "
                         "prewarm.enabled=false")
    ap.add_argument("--task-runners", type=int, default=None,
                    help="[worker] runner slots of the shared split "
                         "scheduler (0 = max(4, 2 x cores)); also "
                         "task.runner-threads in config.properties / env "
                         "TRINO_TPU_TASK_RUNNERS")
    args = ap.parse_args(argv)

    props = _etc_properties(args.etc_dir)
    if (args.role or props.get("node.role", "coordinator")) == "worker":
        return _worker_main(args, props)
    co = coordinator_from_etc(args.etc_dir, args.device, args.port,
                              args.spool_backend, args.workers,
                              args.distributed).start()
    if co.workers and co.failure_detector is not None:
        # a configured fleet gets the heartbeat loop on top of the
        # schedulers' task-failure feedback
        co.failure_detector.start()
    print(f"trino-tpu-torch coordinator on {co.device} listening on "
          f"{co.base_uri} (web UI: {co.base_uri}/ui)", flush=True)
    _announce_fault_points()

    stop = {"flag": False}

    def on_signal(sig, frame):
        print("draining...", file=sys.stderr)
        co.drain(timeout=30.0)
        stop["flag"] = True

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)
    while not stop["flag"]:
        time.sleep(0.2)
    return 0


def _announce_fault_points() -> None:
    """Startup banner for TRINO_TPU_FAULTPOINTS (fte/faultpoints.py): an
    armed schedule changes what this process does, so it is printed,
    and a malformed spec fails at boot."""
    spec = os.environ.get("TRINO_TPU_FAULTPOINTS", "").strip()
    if not spec:
        return
    from ..fte.faultpoints import armed_sites, parse_schedule
    parse_schedule(spec)     # raises ValueError on a malformed spec
    armed = armed_sites()
    print("FAULT INJECTION ARMED (TRINO_TPU_FAULTPOINTS): "
          + ", ".join(f"{site}={action}"
                      for site, action in sorted(armed.items())),
          file=sys.stderr)


def _worker_main(args, props: Dict[str, str]) -> int:
    """Worker role: a TaskWorkerServer on ``--device`` that joins a
    coordinator's worker set at run time (/v1/announcement) and leaves
    it on SIGTERM or SIGINT."""
    from .task_worker import TaskWorkerServer
    port = args.port if args.port is not None else \
        int(props.get("http-server.http.port", "0"))
    spool_backend = (args.spool_backend
                     or props.get("spool.backend") or None)
    plugins = [m for m in props.get("plugin.load", "").split(",") if m]
    task_runners = args.task_runners
    if task_runners is None and props.get("task.runner-threads"):
        task_runners = int(props["task.runner-threads"])
    srv = TaskWorkerServer(
        port=port, spool_backend=spool_backend,
        task_runners=task_runners, device=args.device,
        # the worker resolves the catalogs the coordinator dispatches
        # fragments against
        catalogs=build_catalogs(args.etc_dir, plugins,
                                args.device)).start()
    coordinator_uri = (args.coordinator_uri
                       or props.get("discovery.uri") or None)
    token = (args.coordinator_token or props.get("discovery.token")
             or os.environ.get("TRINO_TPU_COORDINATOR_TOKEN") or None)
    if coordinator_uri:
        from ..config import CONFIG
        prewarm = CONFIG.prewarm_enabled
        if props.get("prewarm.enabled", "").lower() in ("false", "0"):
            prewarm = False
        top_k = args.prewarm_top_k
        if top_k is None and props.get("prewarm.top-k"):
            top_k = int(props["prewarm.top-k"])
        joined = srv.announce(coordinator_uri, token=token,
                              prewarm=prewarm, prewarm_top_k=top_k)
        print(f"trino-tpu-torch worker {srv.node_id} on {srv.device} "
              f"listening on {srv.base_uri} "
              f"({'joined' if joined else 'announcing to'} "
              f"{coordinator_uri}"
              + (", pre-warming hot shapes" if prewarm else "") + ")",
              flush=True)
    else:
        print(f"trino-tpu-torch worker {srv.node_id} on {srv.device} "
              f"listening on {srv.base_uri} (standalone: pass "
              "--coordinator-uri to join a cluster)", flush=True)
    _announce_fault_points()

    stop = {"flag": False}

    def on_signal(sig, frame):
        srv.stop()               # graceful leave + server shutdown
        stop["flag"] = True

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)
    while not stop["flag"]:
        time.sleep(0.2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
