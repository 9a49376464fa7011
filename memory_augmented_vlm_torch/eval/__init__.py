"""Evaluation surface of the port: checkpoint loading
(`builder.load_pretrained_model`) and the model object it returns
(`model.MavlmForCausalLM`)."""
