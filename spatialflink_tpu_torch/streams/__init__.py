"""Point-stream ingestion and result sinks."""
