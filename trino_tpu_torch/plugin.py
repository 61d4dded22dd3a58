"""Plugin SPI + loader: dynamic connector/function registration.

Counterpart of ``trino_tpu/plugin.py``. A plugin is an importable module
exposing ``get_connector_factories()`` (and optionally
``get_functions()``); isolation comes from the module system rather than
per-plugin classloaders. Every factory builds its connector on the
device the caller names (cuda unless ``device="cpu"``); a factory of
two arguments (catalog name, properties) builds it where it likes.
Plugin functions register into this package's ``functions.py`` typing
and ``exec/expr.py`` dispatch.

Reference parity: core/trino-spi/.../Plugin.java:35-90 (a plugin
contributes connector factories, types, functions, access controls,
event listeners) + server/PluginManager.java.
"""

from __future__ import annotations

import importlib
import inspect
from typing import Callable, Dict, List, Optional

from .config import DeviceLike


class ConnectorFactory:
    """spi/connector/ConnectorFactory: name + create(catalog, props).
    ``create`` takes (catalog name, properties) or (catalog name,
    properties, device)."""

    def __init__(self, name: str, create: Callable):
        self.name = name
        self._create = create
        try:
            nparams = len(inspect.signature(create).parameters)
        except (TypeError, ValueError):
            nparams = 2
        self._takes_device = nparams >= 3

    def create(self, catalog_name: str, props: Dict[str, str],
               device: DeviceLike = None):
        if self._takes_device:
            return self._create(catalog_name, props, device)
        return self._create(catalog_name, props)


_FACTORIES: Dict[str, ConnectorFactory] = {}


def register_factory(factory: ConnectorFactory) -> None:
    _FACTORIES[factory.name] = factory


def connector_factories() -> List[str]:
    _ensure_builtins()
    return sorted(_FACTORIES)


def load_plugin(module_path: str) -> List[str]:
    """Import a plugin module and register its factories
    (PluginManager.installPlugin). Returns the factory names added."""
    mod = importlib.import_module(module_path)
    added = []
    get = getattr(mod, "get_connector_factories", None)
    if get is None:
        raise ValueError(
            f"plugin module {module_path!r} has no "
            "get_connector_factories()")
    for f in get():
        if not isinstance(f, ConnectorFactory):
            name, create = f  # (name, callable) tuple form
            f = ConnectorFactory(name, create)
        register_factory(f)
        added.append(f.name)
    for reg in getattr(mod, "get_functions", lambda: [])():
        # (name, typing_fn, eval_fn): contribute a scalar builtin
        fname, typing_fn, eval_fn = reg
        from . import functions as _fns
        from .exec import expr as _expr
        _fns._SCALARS[fname] = typing_fn
        _expr._DISPATCH[fname] = eval_fn
        added.append(fname)
    return added


def create_connector(kind: str, catalog_name: str,
                     props: Optional[Dict[str, str]] = None,
                     device: DeviceLike = None):
    """connector.name -> Connector instance on ``device``; ``kind`` may
    also be a 'module.path:factory_name' reference, loaded on demand."""
    _ensure_builtins()
    props = props or {}
    if kind not in _FACTORIES and ":" in kind:
        module_path, _, fname = kind.partition(":")
        load_plugin(module_path)
        kind = fname
    f = _FACTORIES.get(kind)
    if f is None:
        raise KeyError(
            f"unknown connector.name '{kind}' (available: "
            f"{', '.join(sorted(_FACTORIES))})")
    return f.create(catalog_name, props, device)


_BUILTINS_DONE = False


def _ensure_builtins() -> None:
    global _BUILTINS_DONE
    if _BUILTINS_DONE:
        return
    _BUILTINS_DONE = True
    from .connectors.memory import BlackholeConnector, MemoryConnector
    from .connectors.system import SystemConnector
    from .connectors.tpcds import TpcdsConnector
    from .connectors.tpch import TpchConnector

    def _tpch(n, p, device):
        if "tpch.rows-per-split" in p:
            return TpchConnector(int(p["tpch.rows-per-split"]),
                                 device=device)
        return TpchConnector(device=device)
    register_factory(ConnectorFactory("tpch", _tpch))
    register_factory(ConnectorFactory(
        "tpcds", lambda n, p, device: TpcdsConnector(device=device)))
    register_factory(ConnectorFactory(
        "memory", lambda n, p, device: MemoryConnector(device)))
    register_factory(ConnectorFactory(
        "blackhole", lambda n, p, device: BlackholeConnector(device)))
    register_factory(ConnectorFactory(
        "system", lambda n, p, device: SystemConnector(device=device)))

    def _stream(n, p, device):
        raise NotImplementedError("not yet ported: the stream connector")
    register_factory(ConnectorFactory("stream", _stream))

    def _localfile(n, p, device):
        from .connectors.localfile import LocalFileConnector
        return LocalFileConnector(p.get("localfile.root", "."), device)
    register_factory(ConnectorFactory("localfile", _localfile))

    def _jdbc(n, p, device):
        from .connectors.jdbc import SqliteConnector
        return SqliteConnector(p.get("connection-url", ":memory:"),
                               p.get("jdbc.schema", "public"), device)
    register_factory(ConnectorFactory("jdbc", _jdbc))
