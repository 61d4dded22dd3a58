"""Server entry point: ``python -m trino_tpu_torch.server.main``.

Counterpart of ``trino_tpu/server/main.py`` (host only): the airlift
config model, ``etc/config.properties`` (http-server.http.port,
resource-groups.config-file, password-authenticator.file,
query.max-memory, scan-cache.max-size, spool.backend, plugin.load) and
``etc/catalog/*.properties`` (connector.name=tpch|memory|...,
through plugin.py). The coordinator serves on ``--device`` (default
``cuda``; no card is an error unless ``--device cpu`` is given). A
config naming the worker role (``node.role=worker``) or workers
(``worker.uris``) is refused: workers are not yet ported.
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
    ``device``. Without catalog files: tpch, tpcds, memory and
    blackhole."""
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
        for kind in ("tpch", "tpcds", "memory", "blackhole"):
            mgr.register(kind, plugin.create_connector(kind, kind,
                                                       device=dev))
    return mgr


def coordinator_from_etc(etc_dir: Optional[str], device="cuda",
                         port: Optional[int] = None,
                         spool_backend: Optional[str] = None):
    """The Coordinator (not yet started) that ``etc_dir`` describes:
    config.properties and catalog/*.properties; ``port`` and
    ``spool_backend`` beat their properties."""
    props: Dict[str, str] = {}
    if etc_dir:
        cfg = os.path.join(etc_dir, "config.properties")
        if os.path.exists(cfg):
            props = load_properties(cfg)
    # plugin.load=<module>[,<module>...] loads plugin modules before the
    # catalogs resolve
    plugins = [m for m in props.get("plugin.load", "").split(",") if m]
    if port is None:
        port = int(props.get("http-server.http.port", "8080"))
    # a shared etc/ may name the cluster roles that wait for the worker
    # slice: refuse them rather than serve as a lone coordinator
    if props.get("node.role", "coordinator") == "worker":
        raise SystemExit("not yet ported: the worker role")
    workers = [w.strip() for w in props.get("worker.uris", "").split(",")
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
    return Coordinator(port=port,
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
    ap.add_argument("--device", default="cuda",
                    help="torch device the queries run on: cuda "
                         "(default) or cpu")
    ap.add_argument("--spool-backend", default=None,
                    help="spool backend for restart recovery: 'local' "
                         "(directory tree); also spool.backend in "
                         "config.properties / env TRINO_TPU_SPOOL_BACKEND")
    args = ap.parse_args(argv)

    co = coordinator_from_etc(args.etc_dir, args.device, args.port,
                              args.spool_backend).start()
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


if __name__ == "__main__":
    raise SystemExit(main())
