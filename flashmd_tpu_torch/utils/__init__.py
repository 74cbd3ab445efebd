from .io import dump_yaml, load_yaml, logger, setup_logging, tqdm  # noqa: F401
