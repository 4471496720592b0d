"""Gradio WebUI of the PyTorch port (counterpart of
indextts_tpu/serve/webui.py; reference surface: webui.py:24-422).

Tabs: generation (prompt upload + text + sampling/bucketing sliders), model
dropdown with hot reload, live sentence-split preview, examples from
tests/cases.jsonl.

gradio is an optional extra: the UI-independent logic (model discovery,
examples parsing, the reload/preview/synthesize callbacks over the port's
`engine.IndexTTS`) lives in plain functions importable and testable without
gradio; only ``create_demo``/``main`` require it.  The engine runs on the
card unless ``device="cpu"`` is given.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Optional

try:  # pragma: no cover - exercised only when gradio is installed
    import gradio as gr
    _GRADIO_ERROR: Optional[ImportError] = None
except ImportError as e:  # pragma: no cover
    gr = None
    _GRADIO_ERROR = e


def discover_models(model_dir: str) -> List[str]:
    """All .pth checkpoints under model_dir, relative paths, sorted
    (reference webui.py:107-140 model dropdown)."""
    out = []
    for root, _, files in os.walk(model_dir):
        for name in files:
            if name.endswith(".pth"):
                out.append(os.path.relpath(os.path.join(root, name), model_dir))
    return sorted(out)


def parse_examples(cases_path: Optional[str]) -> List[List[str]]:
    """Example texts from a tests/cases.jsonl file; malformed lines are
    skipped (reference webui.py:170-184)."""
    examples: List[List[str]] = []
    if cases_path and os.path.exists(cases_path):
        with open(cases_path, "r", encoding="utf-8") as f:
            for line in f:
                try:
                    case = json.loads(line)
                    text = case.get("text", "")
                    if text:
                        examples.append([text])
                except json.JSONDecodeError:
                    pass
    return examples


def build_callbacks(cfg_path: str, model_dir: str,
                    engine_factory: Callable[..., Any] = None,
                    out_dir: str = "outputs",
                    device: Optional[str] = None) -> Dict[str, Callable]:
    """The WebUI's three actions as plain callables over a shared engine
    slot.  ``engine_factory`` defaults to the port's IndexTTS on ``device``
    (the card by default); tests inject a stub."""
    if engine_factory is None:
        from functools import partial

        from indextts_tpu_torch.engine import IndexTTS

        engine_factory = partial(IndexTTS, device=device)

    state = {"tts": engine_factory(cfg_path=cfg_path, model_dir=model_dir)}

    def reload_model(gpt_path):
        state["tts"] = engine_factory(cfg_path=cfg_path, model_dir=model_dir,
                                      gpt_path=gpt_path or None)
        return f"loaded: {gpt_path or 'default'}"

    def preview_split(text, max_tokens):
        tts = state["tts"]
        tokens = tts.tokenizer.tokenize(text)
        sents = tts.tokenizer.split_sentences(tokens, int(max_tokens))
        return [[i, len(s), "".join(s).replace("▁", " ")]
                for i, s in enumerate(sents)]

    def synthesize(prompt, text, mode, max_tokens, bucket_size, do_sample,
                   top_p, top_k, temperature, repetition_penalty,
                   max_mel_tokens, num_beams=3, cfg_scale=1.0,
                   length_penalty=0.0, progress=None):
        tts = state["tts"]
        tts.gr_progress = progress
        gen = dict(do_sample=do_sample, top_p=top_p, top_k=int(top_k),
                   temperature=temperature,
                   repetition_penalty=repetition_penalty,
                   length_penalty=float(length_penalty),
                   max_mel_tokens=int(max_mel_tokens),
                   num_beams=int(num_beams), cfg_scale=float(cfg_scale))
        if float(cfg_scale) != 1.0 and int(num_beams) > 1:
            # guidance is a sampling-mode feature (the slider says so): the
            # UI always carries a num_beams value (slider default 3), which
            # would defeat the engine's "cfg_scale without explicit
            # num_beams → sampling" auto-switch and silently decode
            # unguided (engine.py:456).  num_beams=1 IS sampling mode and
            # passes through.
            gen.pop("num_beams")
        out_path = os.path.join(out_dir, "webui_gen.wav")
        if mode == "fast":
            return tts.infer_fast(prompt, text, out_path,
                                  max_text_tokens_per_sentence=int(max_tokens),
                                  sentences_bucket_max_size=int(bucket_size),
                                  **gen)
        return tts.infer(prompt, text, out_path,
                         max_text_tokens_per_sentence=int(max_tokens), **gen)

    return {"state": state, "reload_model": reload_model,
            "preview_split": preview_split, "synthesize": synthesize}


def create_demo(cfg_path: str, model_dir: str,
                cases_path: Optional[str] = None, device: Optional[str] = None) -> "gr.Blocks":
    if gr is None:  # pragma: no cover
        raise ImportError(
            "gradio is required for the WebUI: pip install gradio"
        ) from _GRADIO_ERROR
    cb = build_callbacks(cfg_path, model_dir, device=device)

    def synthesize_ui(*args, progress=gr.Progress()):
        return cb["synthesize"](*args, progress=progress)

    examples = parse_examples(cases_path)

    with gr.Blocks(title="IndexTTS") as demo:
        gr.Markdown("# IndexTTS — zero-shot TTS")
        with gr.Tab("Generate"):
            prompt = gr.Audio(label="Reference voice", type="filepath")
            text = gr.Textbox(label="Text", lines=4)
            mode = gr.Radio(["normal", "fast"], value="fast", label="Mode")
            with gr.Accordion("Sampling", open=False):
                do_sample = gr.Checkbox(value=True, label="do_sample")
                top_p = gr.Slider(0.1, 1.0, 0.8, label="top_p")
                top_k = gr.Slider(1, 100, 30, step=1, label="top_k")
                temperature = gr.Slider(0.1, 2.0, 1.0, label="temperature")
                repetition_penalty = gr.Slider(1.0, 20.0, 10.0, label="repetition_penalty")
                max_mel_tokens = gr.Slider(50, 800, 600, step=10, label="max_mel_tokens")
                max_tokens = gr.Slider(20, 300, 100, step=2,
                                        label="max_text_tokens_per_sentence")
                bucket_size = gr.Slider(1, 16, 4, step=1,
                                         label="sentences_bucket_max_size")
                num_beams = gr.Slider(1, 8, 3, step=1, label="num_beams")
                cfg_scale = gr.Slider(1.0, 5.0, 1.0, step=0.1,
                                       label="cfg_scale (guidance; sampling mode)")
                length_penalty = gr.Slider(-2.0, 2.0, 0.0, step=0.1,
                                            label="length_penalty (beams)")
            btn = gr.Button("Synthesize", variant="primary")
            audio_out = gr.Audio(label="Output")
            btn.click(synthesize_ui,
                      [prompt, text, mode, max_tokens, bucket_size, do_sample,
                       top_p, top_k, temperature, repetition_penalty,
                       max_mel_tokens, num_beams, cfg_scale, length_penalty],
                      audio_out)
            with gr.Accordion("Sentence split preview", open=False):
                preview_btn = gr.Button("Preview split")
                preview = gr.Dataframe(headers=["#", "tokens", "text"])
                preview_btn.click(cb["preview_split"], [text, max_tokens], preview)
            if examples:
                gr.Examples(examples, inputs=[text])
        with gr.Tab("Model"):
            models = gr.Dropdown(discover_models(model_dir), label="GPT checkpoint")
            reload_btn = gr.Button("Reload")
            status = gr.Textbox(label="Status")
            reload_btn.click(cb["reload_model"], [models], status)
    return demo


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="IndexTTS WebUI (PyTorch)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--config", default="checkpoints/config.yaml")
    p.add_argument("--model_dir", default="checkpoints")
    p.add_argument("--cases", default="tests/cases.jsonl")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    demo = create_demo(args.config, args.model_dir, args.cases, device=args.device)
    demo.launch(server_name=args.host, server_port=args.port)


if __name__ == "__main__":
    main()
