from attention_tpu_torch.core.oracle import attention_oracle  # noqa: F401
from attention_tpu_torch.core.testcase import (  # noqa: F401
    SUITE,
    TestCase,
    generate_testcase,
    read_testcase,
    verify,
    verify_file,
    write_testcase,
)
