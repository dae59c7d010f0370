"""Native (C++) host components of the port.

`loader`: JPEG/PNG decode, letterbox and collate over a persistent worker
pool, built with g++ on first use (`loader.is_available()`).
"""

from . import loader  # noqa: F401
