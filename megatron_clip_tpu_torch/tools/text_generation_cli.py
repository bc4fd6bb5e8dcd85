"""CLI client for the text-generation REST server.

The counterpart of the root `tools/text_generation_cli.py` (megatron's
tools/text_generation_cli.py): reads prompts from stdin, one a line, PUTs
each to the server and prints the completion.

  python -m megatron_clip_tpu_torch.tools.run_text_generation_server \\
      --port 5000 ... &
  echo "a photo of" | \\
      python -m megatron_clip_tpu_torch.tools.text_generation_cli \\
      localhost:5000 [tokens_to_generate] [temperature]
"""
import json
import sys
import urllib.request


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: text_generation_cli.py <host:port> "
              "[tokens_to_generate] [temperature]", file=sys.stderr)
        return 2
    addr = argv[0] if argv[0].startswith("http") else f"http://{argv[0]}"
    n_tokens = int(argv[1]) if len(argv) > 1 else 32
    temperature = float(argv[2]) if len(argv) > 2 else 1.0
    for line in sys.stdin:
        prompt = line.strip()
        if not prompt:
            continue
        payload = json.dumps({"prompts": [prompt],
                              "tokens_to_generate": n_tokens,
                              "temperature": temperature}).encode()
        req = urllib.request.Request(
            addr + "/api", data=payload, method="PUT",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req) as r:
            out = json.loads(r.read())
        print(out["text"][0], flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
