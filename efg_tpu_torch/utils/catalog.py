"""Model-zoo URI handlers: ``catalog://`` and ``detectron2://`` (a copy
of `efg_tpu/utils/catalog.py`).

Resolving a zoo URI yields its public download URL, which the HTTP handler
fetches into `$EFG_CACHE_DIR/downloads/<hash>/` once; a file already there
is used as it is. The resolved `.pkl`/`.pth` then goes through
`utils/torch_import.py` like any local checkpoint. Without a network the
resolution still works and only the fetch raises, with the URL in the
message. Importing this module registers the handlers with `PathManager`.
"""

from __future__ import annotations

import logging
import os
from typing import IO, Any, List

from efg_tpu_torch.utils.file_io import PathHandler, PathManager, get_cache_dir

logger = logging.getLogger(__name__)


class ModelCatalog:
    """Symbolic-name → public URL registry (reference `catalog.py:10-88`).

    Ships the ImageNet-pretrained backbone entries the reference configs
    use (`MODEL.WEIGHTS: "catalog://ImageNetPretrained/MSRA/R-50"` etc.);
    `register()` adds project-specific entries.
    """

    S3_C2_PREFIX = "https://dl.fbaipublicfiles.com/detectron"

    _ENTRIES = {
        # ImageNet-pretrained backbones (Caffe2 conversions the d2/EFG
        # configs reference)
        "ImageNetPretrained/MSRA/R-50": "ImageNetPretrained/MSRA/R-50.pkl",
        "ImageNetPretrained/MSRA/R-101": "ImageNetPretrained/MSRA/R-101.pkl",
        "ImageNetPretrained/FAIR/R-50-GN": "ImageNetPretrained/47261647/R-50-GN.pkl",
        "ImageNetPretrained/FAIR/R-101-GN": "ImageNetPretrained/47592356/R-101-GN.pkl",
        "ImageNetPretrained/FAIR/X-101-32x8d": "ImageNetPretrained/20171220/X-101-32x8d.pkl",
        "ImageNetPretrained/FAIR/X-101-64x4d": "ImageNetPretrained/FBResNeXt/X-101-64x4d.pkl",
        "ImageNetPretrained/FAIR/X-152-32x8d-IN5k": "ImageNetPretrained/25093814/X-152-32x8d-IN5k.pkl",
    }

    @classmethod
    def register(cls, name: str, rel_url: str) -> None:
        cls._ENTRIES[name] = rel_url

    @classmethod
    def get(cls, name: str) -> str:
        if name not in cls._ENTRIES:
            raise KeyError(
                f"catalog://{name} is not a known model-zoo entry; known: "
                f"{sorted(cls._ENTRIES)}"
            )
        return f"{cls.S3_C2_PREFIX}/{cls._ENTRIES[name]}"


class HTTPURLHandler(PathHandler):
    """Download-and-cache for http(s) URLs (reference PathManager's
    HTTPURLHandler). Cache key is the URL basename under
    `$EFG_CACHE_DIR/downloads/<url-hash>/`."""

    def get_supported_prefixes(self) -> List[str]:
        return ["http://", "https://"]

    def get_local_path(self, path: str) -> str:
        import hashlib
        import urllib.request

        h = hashlib.sha1(path.encode()).hexdigest()[:16]
        cache = os.path.join(get_cache_dir(), "downloads", h)
        os.makedirs(cache, exist_ok=True)
        local = os.path.join(cache, os.path.basename(path.split("?")[0]) or "file")
        if not os.path.exists(local):
            logger.info(f"Downloading {path} -> {local}")
            tmp = local + ".part"
            urllib.request.urlretrieve(path, tmp)  # raises offline, URL in msg
            os.replace(tmp, local)
        return local

    def open(self, path: str, mode: str = "r", **kwargs: Any) -> IO[Any]:
        assert "w" not in mode and "a" not in mode, "http paths are read-only"
        return open(self.get_local_path(path), mode, **kwargs)

    def exists(self, path: str) -> bool:
        # existence = resolvable; avoid a network roundtrip here
        return True


class ModelCatalogHandler(PathHandler):
    """Resolve ``catalog://<name>`` (reference `catalog.py:91-109`)."""

    PREFIX = "catalog://"

    def get_supported_prefixes(self) -> List[str]:
        return [self.PREFIX]

    def get_local_path(self, path: str) -> str:
        url = ModelCatalog.get(path[len(self.PREFIX):])
        logger.info(f"Catalog entry {path} points to {url}")
        return PathManager.get_local_path(url)

    def open(self, path: str, mode: str = "r", **kwargs: Any) -> IO[Any]:
        return PathManager.open(self.get_local_path(path), mode, **kwargs)

    def exists(self, path: str) -> bool:
        try:
            ModelCatalog.get(path[len(self.PREFIX):])
            return True
        except KeyError:
            return False


class Detectron2Handler(PathHandler):
    """Resolve ``detectron2://<zoo path>`` (reference `catalog.py:111-126`)."""

    PREFIX = "detectron2://"
    S3_DETECTRON2_PREFIX = "https://dl.fbaipublicfiles.com/detectron2/"

    def get_supported_prefixes(self) -> List[str]:
        return [self.PREFIX]

    def get_local_path(self, path: str) -> str:
        return PathManager.get_local_path(
            self.S3_DETECTRON2_PREFIX + path[len(self.PREFIX):]
        )

    def open(self, path: str, mode: str = "r", **kwargs: Any) -> IO[Any]:
        return PathManager.open(self.get_local_path(path), mode, **kwargs)

    def exists(self, path: str) -> bool:
        return True


PathManager.register_handler(HTTPURLHandler())
PathManager.register_handler(ModelCatalogHandler())
PathManager.register_handler(Detectron2Handler())
