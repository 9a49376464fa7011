"""Model components of the port: SigLIP tower, projector, temporal PE,
recurrent memory, Qwen2 LM and the video assembly."""
