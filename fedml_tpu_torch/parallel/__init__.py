"""Host-side pipelining of round inputs."""
