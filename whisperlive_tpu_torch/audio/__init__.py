"""Host-side audio: wire PCM conversion and the streaming VAD gate."""
