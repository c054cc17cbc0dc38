from .fetch import fetch
from .sentencepiece import SentencePieceModel
from .profiler import Profiler, Tracker
