"""The plain reference the benchmark judges the port by: PyTorch and NumPy
only, no import of the port or of the JAX package, no weight, table or
prompt the port made. It rebuilds the prompts from the text, the weights
from the seed (``ttsd_bench/weights.py``), and recomputes the model's
logits and the codec's audio in float32."""
