"""The engine: WhisperEngine, the continuous slot pool and scheduler, the
window batch scheduler, segment splitting and the tokenizer."""
