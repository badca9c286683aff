"""File IO backends: a copy of ``tpuir/train/file_client.py`` (BasicSR's
``FileClient``, ``basicsr/utils/file_client.py``).

disk is always available; lmdb/memcached are optional and raise with a
clear message when the client library is absent.
"""

from __future__ import annotations

from typing import Dict


class DiskBackend:
    def get(self, filepath: str, client_key: str = "default") -> bytes:
        with open(filepath, "rb") as f:
            return f.read()


class LmdbBackend:
    def __init__(self, db_paths, client_keys=("default",), readonly=True,
                 lock=False, readahead=False):
        try:
            import lmdb
        except ImportError as e:  # pragma: no cover
            raise ImportError(
                "lmdb backend requested but the lmdb package is not installed"
            ) from e
        if isinstance(db_paths, str):
            db_paths = [db_paths]
        if isinstance(client_keys, str):
            client_keys = [client_keys]
        self._clients = {
            key: lmdb.open(path, readonly=readonly, lock=lock, readahead=readahead)
            for key, path in zip(client_keys, db_paths)
        }

    def get(self, filepath: str, client_key: str) -> bytes:
        client = self._clients[client_key]
        with client.begin(write=False) as txn:
            return txn.get(str(filepath).encode("ascii"))


class MemcachedBackend:  # pragma: no cover - optional infra dependency
    def __init__(self, server_list_cfg, client_cfg, sys_path=None):
        try:
            import mc
        except ImportError as e:
            raise ImportError("memcached backend requires the mc package") from e
        self._client = mc.MemcachedClient.GetInstance(server_list_cfg, client_cfg)
        self._mc_buffer = mc.pyvector()

    def get(self, filepath: str, client_key: str = "default") -> bytes:
        import mc

        self._client.Get(filepath, self._mc_buffer)
        return mc.ConvertBuffer(self._mc_buffer)


_BACKENDS: Dict[str, type] = {
    "disk": DiskBackend,
    "lmdb": LmdbBackend,
    "memcached": MemcachedBackend,
}


class FileClient:
    def __init__(self, backend: str = "disk", **kwargs):
        if backend not in _BACKENDS:
            raise ValueError(
                f"backend {backend} not supported; choose from {sorted(_BACKENDS)}"
            )
        self.backend = backend
        self.client = _BACKENDS[backend](**kwargs) if kwargs else _BACKENDS[backend]()

    def get(self, filepath: str, client_key: str = "default") -> bytes:
        return self.client.get(filepath, client_key)
