"""Decode any DAP wire message from a file (or stdin) and pretty-print it.

Equivalent of reference tools/src/bin/dap_decode.rs: `--media-type`
selects the message type; the input is the raw TLS-syntax bytes.
"""

from __future__ import annotations

import argparse
import sys

from .. import messages as m

# media type -> message class (reference dap_decode.rs match arms)
MEDIA_TYPES = {
    "hpke-config-list": m.HpkeConfigList,
    "report": m.Report,
    "aggregation-job-init-req": m.AggregationJobInitializeReq,
    "aggregation-job-continue-req": m.AggregationJobContinueReq,
    "aggregation-job-resp": m.AggregationJobResp,
    "aggregate-share-req": m.AggregateShareReq,
    "aggregate-share": m.AggregateShare,
    "collect-req": m.CollectionReq,
    "collection": m.Collection,
}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="decode a DAP message")
    parser.add_argument("message_file", help="path to message bytes, or - for stdin")
    parser.add_argument(
        "--media-type",
        "-t",
        required=True,
        choices=sorted(MEDIA_TYPES),
        help="DAP media type of the message",
    )
    args = parser.parse_args(argv)

    if args.message_file == "-":
        data = sys.stdin.buffer.read()
    else:
        with open(args.message_file, "rb") as f:
            data = f.read()

    cls = MEDIA_TYPES[args.media_type]
    msg = cls.from_bytes(data)
    print(msg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
