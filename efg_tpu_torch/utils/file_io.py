"""URI-scheme path manager (a copy of `efg_tpu/utils/file_io.py`).

Local paths work out of the box; other schemes (``catalog://``,
``detectron2://``, ``http(s)://``: `utils/catalog.py`) register a
`PathHandler`. Downloaded and cached files land in `$EFG_CACHE_DIR`.
"""

from __future__ import annotations

import os
import shutil
from typing import IO, Any, Dict, List, Optional


def get_cache_dir(cache_dir: Optional[str] = None) -> str:
    cache_dir = cache_dir or os.environ.get("EFG_CACHE_DIR", os.path.expanduser("~/.efg_tpu/cache"))
    os.makedirs(cache_dir, exist_ok=True)
    return cache_dir


class PathHandler:
    def get_supported_prefixes(self) -> List[str]:
        raise NotImplementedError

    def get_local_path(self, path: str) -> str:
        raise NotImplementedError

    def open(self, path: str, mode: str = "r", **kwargs: Any) -> IO[Any]:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def isdir(self, path: str) -> bool:
        return False

    def ls(self, path: str) -> List[str]:
        raise NotImplementedError

    def mkdirs(self, path: str) -> None:
        raise NotImplementedError

    def rm(self, path: str) -> None:
        raise NotImplementedError

    def copy(self, src_path: str, dst_path: str) -> bool:
        raise NotImplementedError


class NativePathHandler(PathHandler):
    def get_local_path(self, path: str) -> str:
        return os.path.expanduser(path)

    def open(self, path: str, mode: str = "r", **kwargs: Any) -> IO[Any]:
        return open(self.get_local_path(path), mode, **kwargs)

    def exists(self, path: str) -> bool:
        return os.path.exists(self.get_local_path(path))

    def isdir(self, path: str) -> bool:
        return os.path.isdir(self.get_local_path(path))

    def ls(self, path: str) -> List[str]:
        return sorted(os.listdir(self.get_local_path(path)))

    def mkdirs(self, path: str) -> None:
        os.makedirs(self.get_local_path(path), exist_ok=True)

    def rm(self, path: str) -> None:
        os.remove(self.get_local_path(path))

    def copy(self, src_path: str, dst_path: str) -> bool:
        shutil.copyfile(src_path, dst_path)
        return True


class _PathManagerImpl:
    def __init__(self):
        self._native = NativePathHandler()
        self._handlers: Dict[str, PathHandler] = {}

    def register_handler(self, handler: PathHandler) -> None:
        for prefix in handler.get_supported_prefixes():
            assert prefix not in self._handlers, f"Duplicate path handler for '{prefix}'"
            self._handlers[prefix] = handler

    def _get_handler(self, path: str) -> PathHandler:
        for prefix, handler in self._handlers.items():
            if path.startswith(prefix):
                return handler
        return self._native

    def get_local_path(self, path: str) -> str:
        return self._get_handler(path).get_local_path(path)

    def open(self, path: str, mode: str = "r", **kwargs: Any) -> IO[Any]:
        return self._get_handler(path).open(path, mode, **kwargs)

    def exists(self, path: str) -> bool:
        return self._get_handler(path).exists(path)

    def isdir(self, path: str) -> bool:
        return self._get_handler(path).isdir(path)

    def ls(self, path: str) -> List[str]:
        return self._get_handler(path).ls(path)

    def mkdirs(self, path: str) -> None:
        self._get_handler(path).mkdirs(path)

    def rm(self, path: str) -> None:
        self._get_handler(path).rm(path)

    def copy(self, src_path: str, dst_path: str) -> bool:
        return self._get_handler(src_path).copy(src_path, dst_path)


PathManager = _PathManagerImpl()
