"""Host utilities: JSONL metrics and step timing."""
