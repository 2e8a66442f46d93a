"""Caption summarization, the port's copy of
`reflecting_reality_tpu/tools/summarize_captions.py` (reference:
examples/brushnet/scripts/summarize_captions.py — distilbart over a captions
CSV so long auto-captions fit CLIP's 77 tokens).

It uses the optional transformers summarization pipeline (the reference's
`sshleifer/distilbart-cnn-12-6`) and falls back to truncating to the first
`max_length` words when the model cannot be built, as the JAX module does:
a fallback of the host's text handling, not of a device."""

from __future__ import annotations

import argparse


def summarize_fn(model_name: str = "sshleifer/distilbart-cnn-12-6",
                 max_length: int = 50, min_length: int = 10):
    try:
        from transformers import pipeline

        summarizer = pipeline("summarization", model=model_name)

        def f(caption: str) -> str:
            return summarizer(caption, max_length=max_length,
                              min_length=min_length, do_sample=False)[0]["summary_text"]

        return f
    except Exception:
        def f(caption: str) -> str:
            words = caption.split()
            return " ".join(words[:max_length])

        return f


def main(argv=None):
    import pandas as pd

    p = argparse.ArgumentParser(description="Summarize long captions in a csv")
    p.add_argument("--csv", type=str, required=True)
    p.add_argument("--out_csv", type=str, required=True)
    p.add_argument("--caption_column", type=str, default="auto_caption")
    p.add_argument("--out_column", type=str, default="auto_caption")
    p.add_argument("--model", type=str, default="sshleifer/distilbart-cnn-12-6")
    p.add_argument("--max_length", type=int, default=50)
    p.add_argument("--min_length", type=int, default=10)
    p.add_argument("--min_words", type=int, default=40,
                   help="only summarize captions longer than this")
    args = p.parse_args(argv)

    df = pd.read_csv(args.csv)
    f = summarize_fn(args.model, args.max_length, args.min_length)
    out = []
    for caption in df[args.caption_column].astype(str):
        out.append(f(caption) if len(caption.split()) > args.min_words else caption)
    df[args.out_column] = out
    df.to_csv(args.out_csv, index=False)
    print(f"wrote {args.out_csv}")


if __name__ == "__main__":
    main()
