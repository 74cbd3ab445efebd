from .keys import *  # noqa: F401,F403
from .system import (  # noqa: F401
    Configuration,
    System,
    TermList,
    collate,
    make_term_list,
    validate_configurations,
    validate_term_list,
)
