from .serving import EngineFullError, LLMEngine, PageAllocator  # noqa: F401
