"""LM serving on the port: batched prefill + decode."""
