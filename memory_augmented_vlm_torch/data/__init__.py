"""Host data modules of the port: image preprocessing, tokenizer glue,
conversation templates, video loading and the native frame loader."""
