"""Gradio web UI for two-speaker dialogue synthesis, port of
``moss_ttsd_tpu/serve/gradio_app.py``: a bilingual (zh/en) interface with
two input modes (Single: one combined prompt audio with an [S1][S2]
script; Role: one prompt audio per speaker), streaming, a LoRA voice
dropdown, example galleries from JSONL, a lazy pipeline singleton and a
status panel. The synthesis callbacks are plain functions over the port's
``TTSPipeline`` (``process_batch``, ``stream_item``). Gradio is optional:
only ``create_gradio_interface`` needs it, and it raises a clear
``ImportError`` without it. Runs on the CUDA card unless ``--platform
cpu``:

    python -m moss_ttsd_torch.serve.gradio_app --tiny
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional

import numpy as np

_PIPELINE = None
_PIPELINE_LOCK = threading.Lock()


# ---------------------------------------------------------------------------
# i18n: the full bilingual label set. Keys are component labels + status
# strings; ui_strings() is pure Python so the toggle contract is testable
# without gradio installed.
# ---------------------------------------------------------------------------

UI_STRINGS = {
    "en": {
        "language": "Language / 语言",
        "header": ("# MOSS-TTSD (TPU-native)\n"
                   "Two-speaker dialogue synthesis — tag speaker turns with "
                   "`[S1]` / `[S2]`."),
        "tab_single": "Single (combined prompt)",
        "tab_role": "Role (per-speaker prompts)",
        "script": "Dialogue script",
        "script_ph": "[S1]Hello! [S2]Hi there...",
        "prompt_transcript": "Prompt transcript",
        "prompt_audio": "Prompt audio",
        "normalize": "Normalize text",
        "normalize_info": ("Recommended: cleans numbers, punctuation and "
                           "special symbols before synthesis"),
        "seed": "Seed",
        "stream": "Stream audio",
        "voice": "Voice (LoRA)",
        "generate": "Generate",
        "output": "Output",
        "status": "Status",
        "s1_transcript": "Speaker 1 transcript",
        "s1_audio": "Speaker 1 audio",
        "s2_transcript": "Speaker 2 transcript",
        "s2_audio": "Speaker 2 audio",
        "examples_single": "Examples (Single)",
        "examples_role": "Examples (Role)",
        "status_no_speech": "Generation produced no valid speech tokens.",
        "status_generated": "Generated {seconds:.1f}s of audio",
        "status_final_text": "final text",
        "status_streaming": "Streaming… {seconds:.1f}s",
    },
    "zh": {
        "language": "Language / 语言",
        "header": ("# MOSS-TTSD（TPU 原生版）\n"
                   "双说话人对话语音合成 — 用 `[S1]` / `[S2]` 标注说话人轮次。"),
        "tab_single": "单音频模式（合并参考音频）",
        "tab_role": "角色模式（分说话人参考音频）",
        "script": "对话文本",
        "script_ph": "[S1]你好！[S2]你好呀……",
        "prompt_transcript": "参考音频文本",
        "prompt_audio": "参考音频",
        "normalize": "文本规整",
        "normalize_info": "建议开启：合成前清理数字、标点和特殊符号",
        "seed": "随机种子",
        "stream": "流式输出",
        "voice": "音色（LoRA）",
        "generate": "开始合成",
        "output": "合成结果",
        "status": "状态信息",
        "s1_transcript": "说话人 1 文本",
        "s1_audio": "说话人 1 音频",
        "s2_transcript": "说话人 2 文本",
        "s2_audio": "说话人 2 音频",
        "examples_single": "示例（单音频）",
        "examples_role": "示例（角色）",
        "status_no_speech": "生成结果中没有有效的语音 token。",
        "status_generated": "已生成 {seconds:.1f} 秒音频",
        "status_final_text": "最终文本",
        "status_streaming": "流式合成中… {seconds:.1f} 秒",
    },
}

# language-radio update targets, in the fixed order the change event emits
# them (one entry per component, both tabs included). Each entry maps
# gr.update kwarg -> UI_STRINGS key, so components with MORE visible text
# than a label (textbox placeholders, checkbox info lines, button values)
# swap all of it. Tabs and Examples are NOT here: dynamic gr.Tab /
# gr.Examples label updates need newer gradio than the "gradio>=4" extra
# guarantees, so those labels are statically bilingual (bilingual_label).
LABELED_COMPONENTS = (
    {"label": "script", "placeholder": "script_ph"},
    {"label": "prompt_transcript"},
    {"label": "prompt_audio"},
    {"label": "normalize", "info": "normalize_info"},
    {"label": "seed"},
    {"label": "stream"},
    {"label": "voice"},
    {"value": "generate"},             # Button text is its value, not label
    {"label": "output"},
    {"label": "status"},
    {"label": "script", "placeholder": "script_ph"},
    {"label": "s1_transcript"},
    {"label": "s1_audio"},
    {"label": "s2_transcript"},
    {"label": "s2_audio"},
    {"label": "normalize", "info": "normalize_info"},
    {"label": "seed"},
    {"label": "voice"},
    {"value": "generate"},
    {"label": "output"},
    {"label": "status"},
)


def ui_strings(lang: str) -> dict:
    """Label set for one UI language ('en' | 'zh' | a radio display value)."""
    return UI_STRINGS["zh" if lang in ("zh", "中文") else "en"]


def bilingual_label(key: str) -> str:
    """'english / 中文' static label for components that can't be updated
    dynamically across all gradio 4.x versions (Tabs, Examples datasets)."""
    return f"{UI_STRINGS['en'][key]} / {UI_STRINGS['zh'][key]}"


def language_updates(lang: str):
    """(header_markdown, [update-kwargs per LABELED_COMPONENTS]) — the
    values the language-radio change event pushes into the components. Pure
    Python for testability; the gradio wiring wraps each kwargs dict in
    gr.update(**kwargs)."""
    s = ui_strings(lang)
    return s["header"], [{kw: s[key] for kw, key in entry.items()}
                         for entry in LABELED_COMPONENTS]


def get_pipeline(loader=None):
    """The lazy global pipeline: built once by ``loader`` (default: the
    tiny random pipeline on the card) and shared by every callback."""
    global _PIPELINE
    with _PIPELINE_LOCK:
        if _PIPELINE is None:
            if loader is None:
                from ..cli.inference import build_tiny_pipeline
                loader = build_tiny_pipeline
            _PIPELINE = loader()
    return _PIPELINE


def load_examples_from_jsonl(paths, limit: int = 20):
    """Full example rows for the UI galleries — audio paths resolved against
    base_path, prompt transcripts, and normalize flags, split into Role /
    Single groups.

    Returns (role_examples, single_examples):
      role row   = [text, s1_audio, s1_text, s2_audio, s2_text, use_normalize]
      single row = [text, prompt_audio, prompt_text, use_normalize]
    Rows whose audio files are missing are dropped so every gallery entry is
    clickable end-to-end.
    """
    if isinstance(paths, str):
        paths = [paths]
    role, single = [], []
    for path in paths:
        if not path or not os.path.exists(path):
            continue
        with open(path, encoding="utf-8") as f:
            for line in f:
                if not line.strip():
                    continue
                data = json.loads(line)
                text = data.get("text", "")
                base = data.get("base_path", os.path.dirname(path) or ".")
                norm = bool(data.get("use_normalize", True))
                if ("prompt_audio_speaker1" in data
                        and "prompt_audio_speaker2" in data):
                    a1 = os.path.join(base, data["prompt_audio_speaker1"])
                    a2 = os.path.join(base, data["prompt_audio_speaker2"])
                    if os.path.exists(a1) and os.path.exists(a2):
                        role.append([text, a1,
                                     data.get("prompt_text_speaker1", ""),
                                     a2,
                                     data.get("prompt_text_speaker2", ""),
                                     norm])
                elif "prompt_audio" in data:
                    a = os.path.join(base, data["prompt_audio"])
                    if os.path.exists(a):
                        single.append([text, a,
                                       data.get("prompt_text", ""), norm])
                else:
                    single.append([text, None, "", norm])
    return role[:limit], single[:limit]


def _to_int16(wav: np.ndarray) -> np.ndarray:
    return (np.clip(wav, -1, 1) * 32767).astype(np.int16)


def synthesize_single(text: str, prompt_text: str, prompt_audio_path: Optional[str],
                      use_normalize: bool = True, seed: int = 0, loader=None,
                      voice: str = "", lang: str = "en"):
    """Single mode: one combined prompt audio + [S1]/[S2] script.

    Returns ((sample_rate, int16 wav), status), the gradio Audio
    component's contract, or (None, status) when no speech came out.
    ``voice`` names a registered LoRA voice ("" = the base model); ``lang``
    localizes the status string."""
    s = ui_strings(lang)
    pipe = get_pipeline(loader)
    item = {"text": text}
    if prompt_audio_path:
        item["prompt_audio"] = prompt_audio_path
        item["prompt_text"] = prompt_text or ""
    texts_data, audio_results = pipe.process_batch(
        [item], use_normalize=use_normalize, seed=seed,
        adapter=voice or None)
    if not audio_results or audio_results[0] is None:
        return None, s["status_no_speech"]
    res = audio_results[0]
    wav = res["audio_data"][0]
    status = (s["status_generated"].format(
        seconds=len(wav) / res["sample_rate"])
        + f" | {s['status_final_text']}: {texts_data[0]['final_text'][:120]}")
    return (res["sample_rate"], _to_int16(wav)), status


def synthesize_role(text: str,
                    s1_text: str, s1_audio_path: Optional[str],
                    s2_text: str, s2_audio_path: Optional[str],
                    use_normalize: bool = True, seed: int = 0, loader=None,
                    voice: str = "", lang: str = "en"):
    """Role mode: separate speaker-1/2 prompt audios; returns as
    ``synthesize_single``."""
    s = ui_strings(lang)
    pipe = get_pipeline(loader)
    item = {"text": text}
    if s1_audio_path:
        item["prompt_audio_speaker1"] = s1_audio_path
        item["prompt_text_speaker1"] = s1_text or ""
    if s2_audio_path:
        item["prompt_audio_speaker2"] = s2_audio_path
        item["prompt_text_speaker2"] = s2_text or ""
    texts_data, audio_results = pipe.process_batch(
        [item], use_normalize=use_normalize, seed=seed,
        adapter=voice or None)
    if not audio_results or audio_results[0] is None:
        return None, s["status_no_speech"]
    res = audio_results[0]
    wav = res["audio_data"][0]
    status = s["status_generated"].format(
        seconds=len(wav) / res["sample_rate"])
    return (res["sample_rate"], _to_int16(wav)), status


def synthesize_single_stream(text: str, prompt_text: str,
                             prompt_audio_path: Optional[str],
                             use_normalize: bool = True, seed: int = 0,
                             loader=None, voice: str = "", lang: str = "en"):
    """Streaming variant of synthesize_single over ``stream_item``: yields
    ((sample_rate, int16 chunk), status) as generation progresses, a
    generator the gradio Audio component consumes with streaming=True."""
    s = ui_strings(lang)
    pipe = get_pipeline(loader)
    item = {"text": text}
    if prompt_audio_path:
        item["prompt_audio"] = prompt_audio_path
        item["prompt_text"] = prompt_text or ""
    total = 0.0
    got = False
    for chunk, sr in pipe.stream_item(item, use_normalize=use_normalize,
                                      seed=seed, adapter=voice or None):
        got = True
        total += len(chunk) / sr
        yield ((sr, _to_int16(chunk)),
               s["status_streaming"].format(seconds=total))
    if not got:
        yield None, s["status_no_speech"]


DEFAULT_EXAMPLE_JSONLS = ("examples/examples.jsonl",
                          "examples/examples_single_reference.jsonl")


def create_gradio_interface(loader=None, examples_jsonl=None, voices=None):
    """Build the Blocks app. Requires gradio. ``voices``: registered LoRA
    adapter names — when non-empty each tab gets a voice dropdown
    ("default" = base model), mapped to the engines' per-request adapters.

    A language radio at the top swaps every visible label, placeholder,
    info line, and button text between English and Chinese: the change
    event pushes gr.update(**kwargs) into each component in
    LABELED_COMPONENTS order, and the click handlers read the radio to
    localize status text. Tab and Examples labels are statically bilingual
    ("en / 中文") — dynamically relabelling those needs newer gradio than
    the 'gradio>=4' extra guarantees."""
    try:
        import gradio as gr
    except ImportError as e:
        raise ImportError(
            "gradio is not installed in this environment; install it to use "
            "the web UI, or use the CLI (moss_ttsd_torch.cli.inference)") from e

    role_ex, single_ex = load_examples_from_jsonl(
        examples_jsonl if examples_jsonl is not None
        else list(DEFAULT_EXAMPLE_JSONLS))
    s = ui_strings("en")

    with gr.Blocks(title="MOSS-TTSD — Spoken Dialogue Synthesis") as demo:
        lang_radio = gr.Radio(choices=["English", "中文"], value="English",
                              label=s["language"])
        header = gr.Markdown(s["header"])
        with gr.Tabs():
            with gr.Tab(bilingual_label("tab_single")):
                text1 = gr.Textbox(label=s["script"], lines=6,
                                   placeholder=s["script_ph"])
                ptext1 = gr.Textbox(label=s["prompt_transcript"], lines=2)
                paudio1 = gr.Audio(label=s["prompt_audio"], type="filepath")
                norm1 = gr.Checkbox(label=s["normalize"], value=True,
                                    info=s["normalize_info"])
                seed1 = gr.Number(label=s["seed"], value=0, precision=0)
                stream1 = gr.Checkbox(label=s["stream"], value=False)
                voice1 = gr.Dropdown(
                    label=s["voice"], value="default",
                    choices=["default"] + list(voices or []),
                    visible=bool(voices))
                btn1 = gr.Button(s["generate"], variant="primary")
                out1 = gr.Audio(label=s["output"], streaming=True,
                                autoplay=True)
                status1 = gr.Textbox(label=s["status"], interactive=False)

                def _single(t, pt, pa, n, sd, stream, v, lang):
                    v = "" if v in (None, "default") else v
                    if stream:
                        yield from synthesize_single_stream(
                            t, pt, pa, n, int(sd), loader, voice=v, lang=lang)
                    else:
                        yield synthesize_single(t, pt, pa, n, int(sd), loader,
                                                voice=v, lang=lang)

                btn1.click(_single,
                           [text1, ptext1, paudio1, norm1, seed1, stream1,
                            voice1, lang_radio],
                           [out1, status1])
                if single_ex:
                    # full rows: text + prompt audio + transcript + normalize
                    gr.Examples(
                        examples=[[t, a, pt, n] for t, a, pt, n in single_ex],
                        inputs=[text1, paudio1, ptext1, norm1],
                        label=bilingual_label("examples_single"))
            with gr.Tab(bilingual_label("tab_role")):
                text2 = gr.Textbox(label=s["script"], lines=6,
                                   placeholder=s["script_ph"])
                with gr.Row():
                    with gr.Column():
                        s1t = gr.Textbox(label=s["s1_transcript"])
                        s1a = gr.Audio(label=s["s1_audio"], type="filepath")
                    with gr.Column():
                        s2t = gr.Textbox(label=s["s2_transcript"])
                        s2a = gr.Audio(label=s["s2_audio"], type="filepath")
                norm2 = gr.Checkbox(label=s["normalize"], value=True,
                                    info=s["normalize_info"])
                seed2 = gr.Number(label=s["seed"], value=0, precision=0)
                voice2 = gr.Dropdown(
                    label=s["voice"], value="default",
                    choices=["default"] + list(voices or []),
                    visible=bool(voices))
                btn2 = gr.Button(s["generate"], variant="primary")
                out2 = gr.Audio(label=s["output"])
                status2 = gr.Textbox(label=s["status"], interactive=False)
                btn2.click(
                    lambda t, a, b, c, d, n, sd, v, lang: synthesize_role(
                        t, a, b, c, d, n, int(sd), loader,
                        voice="" if v in (None, "default") else v, lang=lang),
                    [text2, s1t, s1a, s2t, s2a, norm2, seed2, voice2,
                     lang_radio],
                    [out2, status2])
                if role_ex:
                    gr.Examples(
                        examples=[[t, a1, p1, a2, p2, n]
                                  for t, a1, p1, a2, p2, n in role_ex],
                        inputs=[text2, s1a, s1t, s2a, s2t, norm2],
                        label=bilingual_label("examples_role"))

        # ordered exactly as LABELED_COMPONENTS (tested without gradio in
        # tests/test_torch_serve.py — keep the two in sync)
        labeled = [text1, ptext1, paudio1, norm1, seed1, stream1,
                   voice1, btn1, out1, status1,
                   text2, s1t, s1a, s2t, s2a, norm2, seed2, voice2,
                   btn2, out2, status2]
        assert len(labeled) == len(LABELED_COMPONENTS)

        def _on_lang(choice):
            hdr, updates = language_updates(choice)
            return [gr.update(value=hdr)] + [gr.update(**kw)
                                             for kw in updates]

        lang_radio.change(_on_lang, [lang_radio], [header] + labeled)
    return demo


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(
        description="MOSS-TTSD gradio demo (PyTorch / CUDA port)")
    p.add_argument("--model_path", default=None)
    p.add_argument("--spt_config", default=None)
    p.add_argument("--spt_ckpt", default=None)
    p.add_argument("--examples", default=None)
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--tiny", action="store_true",
                   help="tiny random models (smoke test); also the default "
                        "without --model_path")
    p.add_argument("--platform", choices=["default", "cpu"],
                   default="default",
                   help="default = the CUDA card; cpu = run on the CPU")
    p.add_argument("--lora_adapter", action="append", default=[],
                   metavar="NAME=PATH",
                   help="register a LoRA voice for the dropdown; PATH is a "
                        "lora_factors.npz from the finetune CLI or a peft "
                        "adapter directory. Repeatable")
    p.add_argument("--adapter_alpha", type=float, default=32.0,
                   help="LoRA alpha of lora_factors.npz adapters")
    args = p.parse_args(argv)

    from ..utils.convert_lora import parse_adapter_specs
    adapters = parse_adapter_specs(args.lora_adapter, args.adapter_alpha,
                                   p.error)
    device = "cpu" if args.platform == "cpu" else "cuda"

    def loader():
        if args.tiny or not args.model_path:
            from ..cli.inference import build_tiny_pipeline
            pipe = build_tiny_pipeline(device=device)
        else:
            from ..cli.inference import SPT_CHECKPOINT_PATH, SPT_CONFIG_PATH
            from ..pipeline.batch import TTSPipeline
            pipe = TTSPipeline.load(args.model_path,
                                    args.spt_config or SPT_CONFIG_PATH,
                                    args.spt_ckpt or SPT_CHECKPOINT_PATH,
                                    device=device)
        for name, (tree, alpha, rslora) in adapters.items():
            pipe.engine.register_adapter(name, tree, alpha=alpha,
                                         use_rslora=rslora)
        return pipe

    demo = create_gradio_interface(loader, args.examples,
                                   voices=sorted(adapters))
    demo.launch(server_port=args.port, server_name="0.0.0.0")


if __name__ == "__main__":
    main()
