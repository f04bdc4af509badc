from .dataset import Dataset, list_datasets, load  # noqa: F401
