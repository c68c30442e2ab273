"""The OpenAI-compatible speech server and its client."""
