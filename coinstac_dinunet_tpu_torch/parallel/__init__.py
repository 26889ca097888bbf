from .learner import COINNLearner
from .powersgd import PowerSGDLearner, PowerSGDReducer
from .rankdad import DADLearner, DADReducer
from .reducer import COINNReducer

__all__ = [
    "COINNLearner", "COINNReducer", "PowerSGDLearner", "PowerSGDReducer",
    "DADLearner", "DADReducer",
]
