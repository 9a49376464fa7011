"""Serving of the port: the continuous-batching engine (`batch_engine.py`)
and the HTTP stack over it and over the model: the controller
(`controller.py`), the model worker (`model_worker.py`), the engine-backed
worker (`sglang_worker.py`), the web chat UI (`web_server.py`), the client
(`client.py`) and the terminal chat (`cli.py`)."""
