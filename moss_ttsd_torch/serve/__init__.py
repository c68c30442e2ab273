"""The serving entry points: the OpenAI-compatible speech server and its
client, the podcast generator and the gradio app's synthesis paths."""
