"""Model code of the port: layers, attention, the dense decoder LM, the KV
cache, prefill / decode and the model facade."""
