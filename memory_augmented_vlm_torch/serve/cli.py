"""Interactive chat in the terminal (counterpart of
`memory_augmented_vlm_tpu/serve/cli.py`; the reference's `llava/serve/cli.py`).

    python -m memory_augmented_vlm_torch.serve.cli --model-path DIR \\
        [--image-file img.jpg | --video-file clip.y4m] [--conv-mode qwen_1_5]
        [--device-map cpu]

The weights load on the card; `--device-map cpu` loads them onto the CPU.
A video is sampled by `data/video.load_video` (1 fps) and, like an image,
goes through the host processor. Each answer streams as it decodes; an
empty line, "exit", "quit" or end of input ends the chat.
"""

from __future__ import annotations

import argparse

from memory_augmented_vlm_torch import constants
from memory_augmented_vlm_torch.data.conversation import conv_templates
from memory_augmented_vlm_torch.data.tokenizer import tokenizer_image_token
from memory_augmented_vlm_torch.eval.builder import load_pretrained_model


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model-path", required=True)
    p.add_argument("--model-base", default=None)
    p.add_argument("--image-file", default=None)
    p.add_argument("--video-file", default=None)
    p.add_argument("--conv-mode", default="qwen_1_5")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--max-new-tokens", type=int, default=512)
    p.add_argument("--device-map", default="auto",
                   help="where the weights go: 'auto' (the card), 'cuda[:n]' or 'cpu'")
    args = p.parse_args(argv)

    tokenizer, model, image_processor, _ = load_pretrained_model(
        args.model_path, args.model_base, "llava_qwen", device_map=args.device_map)
    conv = conv_templates[args.conv_mode].copy()

    pixels, modality = None, "text"
    if args.video_file:
        from memory_augmented_vlm_torch.data.video import load_video

        frames, *_ = load_video(args.video_file)
        pixels = image_processor.preprocess(frames)
        modality = "video"
    elif args.image_file:
        from PIL import Image

        pixels = image_processor.preprocess(Image.open(args.image_file))
        modality = "image"

    first = True
    while True:
        try:
            text = input(f"{conv.roles[0].split('|')[-1] or 'user'}: ")
        except EOFError:
            break
        if not text.strip() or text.strip() in ("exit", "quit"):
            break
        if first and pixels is not None:
            text = constants.DEFAULT_IMAGE_TOKEN + "\n" + text
            first = False
        conv.append_message(conv.roles[0], text)
        conv.append_message(conv.roles[1], None)
        prompt = conv.get_prompt()
        ids = tokenizer_image_token(prompt, tokenizer)
        eos = tokenizer.convert_tokens_to_ids("<|im_end|>")
        print("assistant: ", end="", flush=True)
        answer = ""
        all_tokens: list = []
        for chunk in model.generate_stream(
            ids[None], images=[pixels] if pixels is not None else None,
            modalities=[modality], temperature=args.temperature,
            do_sample=args.temperature > 0,
            max_new_tokens=args.max_new_tokens, eos_token_id=eos,
        ):
            # cumulative decode keeps multi-byte characters whole across
            # chunk boundaries
            all_tokens.extend(int(t) for t in chunk)
            full = tokenizer.decode(all_tokens, skip_special_tokens=True)
            print(full[len(answer):], end="", flush=True)
            answer = full
        print()
        conv.messages[-1][1] = answer


if __name__ == "__main__":
    main()
