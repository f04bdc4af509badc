from .helpers import (boxpdf, enable_compilation_cache, find,  # noqa: F401
                      get_cache_dir, rect)
