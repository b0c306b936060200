"""The port's language-model stack: the dense GQA decoder's serving
path (prefill and decode)."""
