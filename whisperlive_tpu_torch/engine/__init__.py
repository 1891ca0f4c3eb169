"""The engine: WhisperEngine, the window batch scheduler and segment
splitting."""
