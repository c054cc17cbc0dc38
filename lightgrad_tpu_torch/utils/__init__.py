from .fetch import fetch
from .sentencepiece import SentencePieceModel
from .profiler import Profiler, Tracker
from .torch_state import load_torch_state_dict, save_torch_state_dict
