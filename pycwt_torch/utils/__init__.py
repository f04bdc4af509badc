from .helpers import boxpdf, find, get_cache_dir, rect  # noqa: F401
